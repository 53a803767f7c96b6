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
    (64, 2048, 34, 4),
    (32, 1054, 34, 6),
], ids=["test_ops-input-k9", "2d-width-k8", "3d-width-k26",
        "wide-tie-laden-k34", "full-scan-merge-width-k34"])
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


@pytest.mark.parametrize("bad,k,exc", [
    (lambda: torch.zeros(4, 8, 2), 4, ValueError),
    (lambda: torch.zeros(4, 8, dtype=torch.float64), 4, TypeError),
    (lambda: torch.zeros(4, 0), 4, ValueError),
    (lambda: torch.zeros(4, 8), 9, ValueError),
    (lambda: torch.zeros(4, 1000), topk.MAX_K + 1, ValueError),
    # the full scan's k + 8 for a k = 300 query: the kNN sorts there
    (lambda: torch.zeros(4, 16384), 308, ValueError),
], ids=["rank", "dtype", "empty-width", "k-above-width", "k-above-max",
        "full-scan-width-k308"])
def test_wrapper_rejects_bad_input(bad, k, exc):
    with pytest.raises(exc, match=str(topk.MAX_K) if k > topk.MAX_K else None):
        topk.topk_smallest(bad(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("q,w,k", [(4096, 864, 26), (1024, 16384, 34)],
                         ids=["epoch-k26", "full-scan-tile-k34"])
def test_kernel_matches_plain_on_card(q, w, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.from_numpy(_tie_laden(q, w, 5)).cuda()
    before = topk.launches
    kv, ks = topk.topk_smallest(x, k)
    pv, ps = topk.topk_smallest_plain(x, k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
