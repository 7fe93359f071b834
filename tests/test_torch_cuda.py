"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc``) every test here
skips, since a CUDA kernel has no CPU mode.  This file imports only
torch, numpy and the port, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (online softmax against a whole-row softmax,
sums in another order) and 2e-2 in bfloat16 (one bf16 rounding of an
output of order 1 is up to 4e-3; the kernel and the plain version round
at different places).  WKV6 outputs grow with the decayed sum over the
sequence, so its tolerances (1e-5 float32, 1e-2 bfloat16) are relative
to the largest output.  Gradients of the kernels' autograd Functions
are the plain versions' own gradients at the same inputs: 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan


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


def wkv_case(device, *, B, H, T, N, dtype, seed=0):
    """r/k/v of order 1 in ``dtype``; w = exp(-exp(w_log)) in float32 as the
    time mix makes it (w_log in [-4, 1], decays from 0.98 down to 0.07)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn(B, H, T, N, generator=g, device=device).to(dtype)
               for _ in range(3))
    w_log = torch.rand(B, H, T, N, generator=g, device=device) * 5 - 4
    w = torch.exp(-torch.exp(w_log))
    u = torch.randn(H, N, generator=g, device=device)
    return r, k, v, w, u


WKV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,N", [(2, 4, 100, 64), (3, 2, 256, 32),
                                     (1, 3, 1, 64)])
def test_cuda_wkv6_matches_plain(cuda, dt, B, H, T, N):
    r, k, v, w, u = wkv_case(cuda, B=B, H=H, T=T, N=N, dtype=dt, seed=T)
    before = rwkv6_scan.launches["wkv6"]
    got = ops.wkv6(r, k, v, w, u)
    want = ref.wkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches["wkv6"] == before + 1
    assert got.dtype == dt
    tol = WKV_TOL[dt] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_wkv6_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u = wkv_case(cuda, B=1, H=2, T=8, N=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6(r, k, v, w, u)
    r, k, v, w, u = wkv_case(cuda, B=1, H=2, T=8, N=64, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6(r, k, v, w.double(), u)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r.transpose(2, 3), k, v, w, u)


def _grads(fn, inputs, g):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
def test_cuda_wkv6_gradient_matches_plain(cuda):
    inputs = wkv_case(cuda, B=2, H=4, T=96, N=64, dtype=torch.float32)
    g = torch.randn(2, 4, 96, 64, device=cuda)
    before = rwkv6_scan.launches["wkv6"]
    out, got = _grads(lambda *a: ops.wkv6(*a, chunk=32), inputs, g)
    assert rwkv6_scan.launches["wkv6"] == before + 1
    ref_out, want = _grads(lambda *a: ref.wkv6_scan(*a, chunk=32), inputs, g)
    for a, b in zip([out] + got, [ref_out] + want):
        tol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_gradient_matches_plain(cuda):
    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(1)
    inputs = [torch.randn(2, 8, 130, 64, generator=gen, device=cuda),
              torch.randn(2, 2, 130, 64, generator=gen, device=cuda),
              torch.randn(2, 2, 130, 64, generator=gen, device=cuda)]
    g = torch.randn(2, 8, 130, 64, generator=gen, device=cuda)
    before = flash_attention.launches["flash_attention"]
    out, got = _grads(lambda *a: ops.flash_attention(*a, causal=True),
                      inputs, g)
    assert flash_attention.launches["flash_attention"] == before + 1
    ref_out, want = _grads(lambda *a: ref.attention_ref(*a, causal=True),
                           inputs, g)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    for a, b in zip(got, want):
        tol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
