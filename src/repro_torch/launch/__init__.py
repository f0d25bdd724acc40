"""Launchers (counterpart of :mod:`repro.launch`): the training launcher.
The reference's mesh construction and multi-pod dry run are not ported
yet."""
