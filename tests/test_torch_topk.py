"""The port's selection kernel ``topk_smallest`` against the JAX package's
Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; it must be
bitwise equal — values and slots, ties and the fewer-than-k-finite caveat
included — to the Pallas kernel run in interpret mode.  The CUDA kernel is
held against the plain version on the card (``cuda`` marker; skips here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparsespatialsampling_tpu.ops.pallas_topk import (  # noqa: E402
    topk_smallest as jax_topk_smallest)
from sparsespatialsampling_torch.ops import topk  # noqa: E402


def _tie_laden(q, w, seed):
    """The input of ``tests/test_ops.py:489-497`` scaled to ``[q, w]``, plus
    a row with fewer finite entries than any tested k."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(q, w)).astype(np.float32)
    x[3, 10] = x[3, 50] = x[3, 5]     # in-set ties
    x[7, :] = 1.0                      # whole-row tie
    x[11, w // 2:] = np.inf            # padded candidates
    x[12, 5:] = np.inf                 # fewer than k finite entries
    x[:, ::9] = np.round(x[:, ::9], 1)  # ties scattered through every row
    return x


@pytest.mark.parametrize("q,w,k,seed", [
    (96, 160, 9, 11),
    (64, 576, 8, 1),
    (72, 864, 26, 2),
], ids=["test_ops-input-k9", "2d-width-k8", "3d-width-k26"])
def test_plain_matches_pallas_interpret(q, w, k, seed):
    x = _tie_laden(q, w, seed)
    jv, js = jax_topk_smallest(jnp.asarray(x), k, interpret=True)
    pv, ps = topk.topk_smallest(torch.from_numpy(x), k)
    assert ps.dtype == torch.int32 and pv.dtype == torch.float32
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # the caveat: past the last finite entry the first +inf slot repeats
    assert (ps.numpy()[12, 5:] == ps.numpy()[12, 5]).all()
    assert np.isinf(pv.numpy()[12, 5:]).all()


def test_cpu_wrapper_is_plain_and_counts_no_launch():
    x = torch.from_numpy(_tie_laden(40, 128, 3))
    before = topk.launches
    a = topk.topk_smallest(x, 8)
    b = topk.topk_smallest_plain(x, 8)
    assert topk.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("bad,exc", [
    (lambda: torch.zeros(4, 8, 2), ValueError),
    (lambda: torch.zeros(4, 8, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(4, 0), ValueError),
], ids=["rank", "dtype", "empty-width"])
def test_wrapper_rejects_bad_input(bad, exc):
    with pytest.raises(exc):
        topk.topk_smallest(bad(), 4)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.from_numpy(_tie_laden(4096, 864, 5)).cuda()
    before = topk.launches
    kv, ks = topk.topk_smallest(x, 26)
    pv, ps = topk.topk_smallest_plain(x, 26)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
