"""Training and serving substrate (counterpart of :mod:`repro.train`):
the optimizer (``optimizer``), the train step (``train_loop``), synthetic
data (``data``), checkpoints (``checkpoint``), gradient compression
(``compression``), fault tolerance (``fault_tolerance``) and the serving
path (``serve``)."""

from . import (checkpoint, compression, data, fault_tolerance, optimizer,
               train_loop)

__all__ = ["checkpoint", "compression", "data", "fault_tolerance",
           "optimizer", "train_loop"]
