"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc``) every test here
skips, since a CUDA kernel has no CPU mode.  This file imports only
torch, numpy and the port, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (online softmax against a whole-row softmax,
sums in another order) and 2e-2 in bfloat16 (one bf16 rounding of an
output of order 1 is up to 4e-3; the kernel and the plain version round
at different places).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.asarray(a))


def paged_case(seed, *, B, KH, G, D, bs, pages, quant, T=None):
    """Random pools, ragged kv_len (one row at 0 context beyond its first
    page), tables whose unused entries point at the trash block 0."""
    rng = np.random.default_rng(seed)
    NB = B * pages + 1
    qshape = (B, KH, G, D) if T is None else (B, KH, G, T, D)
    q = rng.standard_normal(qshape).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (NB, bs, KH, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (NB, bs, KH, D)).astype(np.int8)
        ks = (rng.random((NB, bs, KH)) * 0.05).astype(np.float32)
        vs = (rng.random((NB, bs, KH)) * 0.05).astype(np.float32)
    else:
        kp = rng.standard_normal((NB, bs, KH, D)).astype(np.float32)
        vp = rng.standard_normal((NB, bs, KH, D)).astype(np.float32)
        ks = vs = None
    kv_len = rng.integers(1, pages * bs + 1, B).astype(np.int32)
    kv_len[0] = min(bs, pages * bs)          # one row on its first page only
    ids = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((B, pages), np.int32)
    for b in range(B):
        live = -(-int(kv_len[b]) // bs)
        tables[b, :live] = ids[b * pages:b * pages + live]
    if T is not None:   # mixed form: query t of row b sees < kv_len[b] - T + 1 + t
        kv_len = np.maximum(kv_len[:, None] - T + 1 + np.arange(T)[None],
                            1).astype(np.int32)
    return q, kp, vp, ks, vs, tables, kv_len


# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


CUDA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8-f32",
                                  "int8-bf16"])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 64), (8, 128)])
def test_cuda_paged_decode_matches_plain(cuda, kind, G, D):
    quant = kind.startswith("int8")
    dt = torch.bfloat16 if kind.endswith("bf16") or kind == "bfloat16" \
        else torch.float32
    q, kp, vp, ks, vs, tables, kv_len = paged_case(
        G + D, B=5, KH=3, G=G, D=D, bs=128, pages=3, quant=quant)
    q = _t(q).to(cuda, dt)
    kp, vp = (_t(a).to(cuda) if quant else _t(a).to(cuda, dt)
              for a in (kp, vp))
    kw = {} if ks is None else {"k_scale": _t(ks).to(cuda),
                                "v_scale": _t(vs).to(cuda)}
    tables, kv_len = _t(tables).to(cuda), _t(kv_len).to(cuda)
    got = ops.paged_decode_attention(q, kp, vp, tables, kv_len, **kw)
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, kv_len, **kw)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,S,T,D", [(True, 300, 384, 64),
                                          (True, 77, 77, 128),
                                          (False, 130, 200, 64)])
def test_cuda_flash_matches_plain(cuda, dt, causal, S, T, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(2, 8, S, D, generator=g, device=cuda).to(dt)
    k = torch.randn(2, 2, T, D, generator=g, device=cuda).to(dt)
    v = torch.randn(2, 2, T, D, generator=g, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
