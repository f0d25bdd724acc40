"""The model stack: configs, layers and family assemblies (counterpart of
:mod:`repro.models`)."""
