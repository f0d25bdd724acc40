"""Launchers (counterpart of :mod:`repro.launch`): the training launcher,
device meshes and the multi-pod dry run."""
