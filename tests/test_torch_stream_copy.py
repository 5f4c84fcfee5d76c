"""The stream-copy wrapper and its plain version, on the CPU.

``bench.py``'s Pallas probe kernel (``copy_kernel`` behind ``pallas_copy``)
cannot be imported alone, so the test rebuilds it as bench.py writes it,
at small shapes and in interpret mode, and holds the port's plain copy to
it bit for bit. The kernel itself runs only on a card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from horovod_tpu_torch.ops import stream_copy as sc


def _pallas_copy(x, bm):
    """bench.py's copy_kernel / pallas_copy, interpreted."""
    m, n = x.shape

    def copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        copy_kernel, grid=(m // bm,),
        in_specs=[pl.BlockSpec((bm, n), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        interpret=True)(x)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.uint8])
@pytest.mark.parametrize("m,n,bm", [(64, 128, 16), (48, 256, 48),
                                    (32, 128, 8)])
def test_plain_copy_equals_the_pallas_probe_kernel(dtype, m, n, bm):
    rng = np.random.default_rng(m + n)
    if dtype == np.uint8:
        a = rng.integers(0, 256, (m, n)).astype(np.uint8)
        t = torch.from_numpy(a)
        j = jnp.asarray(a)
    else:
        a = rng.standard_normal((m, n)).astype(np.float32)
        if dtype == "bfloat16":
            t = torch.from_numpy(a).to(torch.bfloat16)
            j = jnp.asarray(a, jnp.bfloat16)
        else:
            t, j = torch.from_numpy(a), jnp.asarray(a)
    want = np.asarray(_pallas_copy(j, bm))
    out = torch.empty_like(t)
    sc.reset_launches()
    got = sc.stream_copy(t, out, rows_per_cta=4)
    assert got is out and sc.LAUNCHES["stream_copy"] == 0
    bits = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
    np.testing.assert_array_equal(
        got.view(bits).numpy(),
        want.view(np.int16) if dtype == "bfloat16" else want)
    np.testing.assert_array_equal(sc.stream_copy_plain(t, torch.empty_like(
        t)).view(bits).numpy(), got.view(bits).numpy())


def test_wrapper_gates():
    x = torch.arange(24.0).reshape(4, 6)
    with pytest.raises(ValueError, match="contiguous"):
        sc.stream_copy(x.t())
    for bad in (torch.empty(6, 4), torch.empty(4, 6, dtype=torch.float64),
                torch.empty(6, 4).t()):
        with pytest.raises(ValueError, match="out must be"):
            sc.stream_copy(x, bad)
    y = sc.stream_copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sc.stream_copy(torch.empty(4, 6, device="meta"),
                       torch.empty(4, 6, device="meta"))
    assert torch.equal(sc.stream_copy(torch.tensor(3.0)), torch.tensor(3.0))
    assert sc.stream_copy(torch.empty(0, 5)).shape == (0, 5)


def test_no_fallback_off_the_card():
    """The probe measures a card: on a CPU device it raises, and asking for
    the card where there is none raises too (no CPU fallback)."""
    with pytest.raises(ValueError, match="CUDA device"):
        sc.bandwidth_probe(device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc.bandwidth_probe()


def test_rows_split_by_the_leading_dim():
    assert sc._rows(torch.empty(7, 3, 5, dtype=torch.bfloat16)) == (7, 30)
    assert sc._rows(torch.empty((), dtype=torch.float32)) == (1, 4)
    assert sc._rows(torch.empty(9, dtype=torch.uint8)) == (9, 1)
