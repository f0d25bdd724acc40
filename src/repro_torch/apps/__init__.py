"""The paper's seven application kernels (§5), on the SIMDRAM substrate.

Counterpart of ``repro.apps``, module for module, with the reference's
names, signatures, defaults and seeds; each ``run()`` adds one keyword,
``torch_device`` (default ``"cuda"``), for where the device it builds
keeps its tensors.

  vgg.py         VGG-13 / VGG-16 quantized inference
  lenet.py       LeNet-5 quantized inference
  knn.py         k-nearest-neighbours (L1 distance + host top-k)
  tpch.py        TPC-H-style predicate scan + aggregate
  bitweaving.py  BitWeaving column scans
  brightness.py  image brightness adjustment (add + clamp predication)
  nn_layers.py   shared quantized-NN blocks + a small end-to-end net

Each kernel builds ``Ref``-chained :class:`~repro_torch.core.bank.BbopInstr`
queues (one independent chain per lane shard — see
:mod:`repro_torch.apps.runtime`) and drains them through
:meth:`~repro_torch.core.isa.SimdramDevice.dispatch`, so the SAME app code
runs on every rung of the backend ladder: ``bitplane`` (or ``cuda``)
→ ``bank`` → ``chip`` → ``channel``.  Host code remains only where the paper also
keeps the CPU involved (top-k, sums, matmul accounting).  Every kernel
verifies against a numpy oracle with a raising check and reports
``verified: True`` plus the per-device command statistics that feed
``benchmarks/paper_tables.py::table_apps``.
"""
