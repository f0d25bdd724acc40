"""The serving path's PuM hook (:mod:`repro_torch.train.serve`).

Counterpart of part of ``repro.train``: the host oracle and the
quantized logit offload.  The training loop, optimizer, data,
checkpointing and the LM server come with the model stack.
"""
