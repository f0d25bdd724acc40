"""The serving path (:mod:`repro_torch.train.serve`).

Counterpart of part of ``repro.train``: ``make_prefill``,
``make_serve_step``, ``Request``, the LM ``Server``, the host oracle and
the quantized logit offload.  The training loop, optimizer, data,
checkpointing, compression and fault tolerance are not ported yet.
"""
