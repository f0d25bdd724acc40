"""The seven paper apps across the port's ladder, on the CPU.

Two parametrized contracts at the sizes of ``tests/test_apps.py``'s
ladder block (``DramConfig(n_banks=2, subarrays_per_bank=2,
n_chips=2)``):

* the ladder contract: every app's output on the port's ``bank``,
  ``chip``, ``channel`` and ``cuda`` rungs is ``==`` its output on the
  port's ``bitplane`` rung, and every run verifies;
* parity: on each of the reference's four rungs the port's output, every
  other key of its result dict, ``totals()`` and every modeled field of
  ``engine_stats`` (all but the wall clocks) are ``==`` the JAX
  package's, bit for bit, on the same seeds.
"""

import numpy as np
import pytest

from repro.apps import (bitweaving as ref_bitweaving, brightness as
                        ref_brightness, knn as ref_knn, lenet as ref_lenet,
                        nn_layers as ref_nn_layers, tpch as ref_tpch,
                        vgg as ref_vgg)
from repro.apps.runtime import engine_stats as ref_engine_stats
from repro.core.isa import SimdramDevice as RefDevice
from repro.core.timing import DramConfig as RefConfig
from repro_torch.apps import (bitweaving, brightness, knn, lenet, nn_layers,
                              tpch, vgg)
from repro_torch.apps.runtime import LADDER, engine_stats
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.timing import DramConfig

SMALL = dict(n_banks=2, subarrays_per_bank=2, n_chips=2)
MEASURED = ("wall_s", "pack_wall_s")


def _apps(knn, tpch, bitweaving, brightness, nn_layers, lenet, vgg):
    """``tests/test_apps.py``'s APPS over either package's modules."""
    return [
        ("knn", lambda d: knn.run(n_points=96, n_features=3, n_bits=5,
                                  device=d)),
        ("tpch", lambda d: tpch.run(n_rows=128, device=d)),
        ("bitweaving", lambda d: bitweaving.run(n_rows=160, n_bits=6,
                                                device=d)),
        ("brightness", lambda d: brightness.run(h=6, w=6, delta=60,
                                                device=d)),
        ("nn_layers", lambda d: nn_layers.run(device=d)),
        ("lenet", lambda d: lenet.run(device=d, conv_channels=(2, 3),
                                      fc_dims=(12, 10))),
        ("vgg13", lambda d: vgg.run("vgg13", img_hw=8, n_layers=3,
                                    device=d)),
    ]


APPS = dict(_apps(knn, tpch, bitweaving, brightness, nn_layers, lenet, vgg))
REF_APPS = dict(_apps(ref_knn, ref_tpch, ref_bitweaving, ref_brightness,
                      ref_nn_layers, ref_lenet, ref_vgg))


def _dev(backend):
    return SimdramDevice(backend=backend, cfg=DramConfig(**SMALL),
                         style="mig", device="cpu")


def _int64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("name", list(APPS))
@pytest.mark.parametrize("backend", ("cuda",) + LADDER[1:])
def test_app_bit_exact_across_ladder(name, backend):
    base = APPS[name](_dev(LADDER[0]))
    r = APPS[name](_dev(backend))
    assert base["verified"] is True and r["verified"] is True
    assert r["backend"] == backend
    np.testing.assert_array_equal(_int64(base["output"]), _int64(r["output"]))


@pytest.mark.parametrize("name", list(APPS))
@pytest.mark.parametrize("backend", LADDER)
def test_app_matches_reference(name, backend):
    ref_dev = RefDevice(backend=backend, cfg=RefConfig(**SMALL), style="mig")
    want = REF_APPS[name](ref_dev)
    dev = _dev(backend)
    got = APPS[name](dev)
    assert set(got) == set(want)
    np.testing.assert_array_equal(_int64(got["output"]),
                                  _int64(want["output"]))
    for k in want:
        if k != "output":
            assert got[k] == want[k], k
    assert dev.totals() == ref_dev.totals()
    es, ref_es = engine_stats(dev), ref_engine_stats(ref_dev)
    assert (es is None) == (ref_es is None)
    if es is not None:
        assert set(es) == set(ref_es)
        assert ({k: v for k, v in es.items() if k not in MEASURED}
                == {k: v for k, v in ref_es.items() if k not in MEASURED})
