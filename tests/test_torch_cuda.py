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
The MoE scatter is a copy (exact); the MoE op's output runs the expert
FFN through cuBLAS on the card and on the CPU in the plain op, so it is
held at 2e-5 of its largest value in float32.  The selective scan's y and
final state are held at 1e-5 of their largest value in float32 (sums in
another order, the SFU's 2^x against ``torch.exp``); bfloat16 y at 1e-2 (one
bf16 rounding of the output), its float32 state at 1e-5; a row whose dt
is 0 keeps its state bitwise.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention, moe_dispatch, ops, ref
from repro_torch.kernels import mamba_scan, paged_decode_attention, rwkv6_scan


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


PAGED_KINDS = ["float32", "bfloat16", "int8-f32", "int8-bf16"]


def _paged_dtypes(kind):
    """(q dtype, pool dtype) of a kind of PAGED_KINDS."""
    dt = torch.bfloat16 if kind.endswith("bf16") or kind == "bfloat16" \
        else torch.float32
    return dt, (torch.int8 if kind.startswith("int8") else dt)


def _paged_on_card(device, kind, *, KH, G, D, bs, lens, pages, seed=0,
                   trash=0.0):
    """q, pools, scales, tables and kv_len on the card for rows of the given
    lengths; the trash block 0 (which every unused table entry names) is
    filled with ``trash`` (its scales too, for int8)."""
    dt, pool_dt = _paged_dtypes(kind)
    g = torch.Generator(device=device).manual_seed(seed + bs + G + D)
    B = len(lens)
    NB = B * pages + 1
    q = torch.randn(B, KH, G, D, generator=g, device=device).to(dt)
    if pool_dt == torch.int8:
        kp, vp = (torch.randint(-127, 128, (NB, bs, KH, D), generator=g,
                                device=device, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(NB, bs, KH, generator=g, device=device) * 0.05
                  for _ in range(2))
        ks[0], vs[0] = trash, trash
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = (torch.randn(NB, bs, KH, D, generator=g, device=device)
                  .to(dt) for _ in range(2))
        kp[0], vp[0] = trash, trash
        kw = {}
    ids = torch.randperm(NB - 1, generator=g, device=device).to(torch.int32) + 1
    tables = torch.zeros(B, pages, dtype=torch.int32, device=device)
    for b, n in enumerate(lens):
        live = -(-n // bs)
        tables[b, :live] = ids[b * pages:b * pages + live]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, kp, vp, tables, kv_len, kw


def _paged_ref(q, kp, vp, tables, kv_len, kw):
    """The plain version over the pools with the trash block zeroed (the
    plain gather reads it, and 0 x NaN is NaN), with the kernel's zeros
    for a row with no cached token."""
    kp, vp = kp.clone(), vp.clone()
    kp[0], vp[0] = 0, 0
    if kw:
        kw = {k: v.clone() for k, v in kw.items()}
        kw["k_scale"][0], kw["v_scale"][0] = 0, 0
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, kv_len, **kw)
    return torch.where((kv_len > 0)[:, None, None, None], want,
                       torch.zeros_like(want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PAGED_KINDS)
@pytest.mark.parametrize("G,D", [(1, 64), (4, 64), (8, 64), (1, 128),
                                 (4, 128), (8, 128)])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_cuda_paged_decode_block_sizes_and_edges(cuda, kind, G, D, bs):
    """Rows of 0, 1, 63, 64, 65, bs, bs + 1 tokens and a full table, at
    block sizes below, at and above the kernel's 64-token range (a range
    spans pages, a page spans ranges), with NaN in the trash block: the
    kernel never reads a table entry at or past ceil(kv_len / bs)."""
    pages = max(3, -(-300 // bs))
    lens = [0, 1, 63, 64, 65, bs, bs + 1, pages * bs]
    case = _paged_on_card(cuda, kind, KH=2, G=G, D=D, bs=bs, lens=lens,
                          pages=pages, trash=float("nan"))
    q, kp, vp, tables, kv_len, kw = case
    key = ("paged_decode_attention_int8" if kw
           else "paged_decode_attention")
    before = paged_decode_attention.launches[key]
    got = ops.paged_decode_attention(q, kp, vp, tables, kv_len, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches[key] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all()), "the trash block leaked in"
    assert bool((got[0] == 0).all()), "kv_len 0 must give zeros"
    tol = CUDA_TOL[q.dtype]
    torch.testing.assert_close(got.float(), _paged_ref(*case).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PAGED_KINDS)
def test_cuda_paged_decode_back_to_back_and_two_streams(cuda, kind):
    """Calls of different shapes in a row on one stream, then the first
    again, with no synchronization between; then two calls at once on two
    streams: a workspace reused too early or a combine ticket left set
    would corrupt a later result."""
    shapes = [dict(KH=8, G=4, D=64, bs=128, pages=8,
                   lens=[1024, 0, 700, 64, 1, 129, 513, 300]),
              dict(KH=4, G=8, D=128, bs=16, pages=40,
                   lens=[640, 130, 17]),
              dict(KH=16, G=1, D=128, bs=64, pages=16,
                   lens=[64, 65, 1024, 241, 267, 87, 110, 71])]
    cases = [_paged_on_card(cuda, kind, seed=i, **s)
             for i, s in enumerate(shapes)]
    cases.append(cases[0])
    run = lambda c: ops.paged_decode_attention(*c[:5], **c[5])
    outs = [run(c) for c in cases]
    torch.cuda.synchronize()
    tol = CUDA_TOL[cases[0][0].dtype]
    for c, got in zip(cases, outs):
        torch.testing.assert_close(got.float(), _paged_ref(*c).float(),
                                   atol=tol, rtol=tol)
    torch.testing.assert_close(outs[0], outs[-1], atol=0, rtol=0)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    both = []
    for s, c in zip(streams, cases[:2]):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            both.append(run(c))
    torch.cuda.synchronize()
    for got, want in zip(both, outs[:2]):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,S,D", [(8, 16, 256, 64), (8, 16, 128, 64),
                                     (2, 16, 300, 64), (2, 8, 300, 128)])
def test_cuda_flash_full_at_the_encoder_shapes(cuda, dt, B, H, S, D):
    """The non-causal form as an encoder runs it: S = T, every head its own
    KV head (seamless' serve and train shapes), and S = T = 300, off the
    tile edges."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=cuda).to(dt)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the bfloat16 kernel takes one-warpgroup CTAs on small grids, two
# warpgroups (two query heads of one KV group) on large ones with an even
# group, and one-warpgroup CTAs two to an SM on large ones with an odd
# group: (B, KH, G) below reach all three at S 700
FLASH_GROUPS = [(2, 2, 1), (2, 2, 4), (2, 2, 8), (2, 16, 1)]
FLASH_EDGES = [(True, 1, 1), (True, 63, 63), (True, 65, 65),
               (True, 127, 200), (False, 129, 129), (True, 700, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,KH,G", FLASH_GROUPS)
@pytest.mark.parametrize("causal,S,T", FLASH_EDGES)
def test_cuda_flash_tile_edges(cuda, dt, D, B, KH, G, causal, S, T):
    """S and T on and off every 64-row / 64-key tile edge; a causal T > S
    is a cache row whose tail past the prompt is zero."""
    g = torch.Generator(device=cuda).manual_seed(S + 7 * T + G)
    q = torch.randn(B, KH * G, S, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, KH, T, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, KH, T, D, generator=g, device=cuda).to(dt)
    if causal:
        k[:, :, S:] = 0
        v[:, :, S:] = 0
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,KH,G,S", [(1, 2, 1, 65), (2, 2, 8, 130),
                                      (1, 16, 1, 700), (1, 8, 8, 675)])
def test_cuda_flash_writes_no_row_past_S(cuda, dt, D, B, KH, G, S):
    """The kernel writes into an output framed by sentinel bands: every
    row it must write is right, and nothing before or after is touched."""
    from repro_torch.kernels import build, flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(S)
    H = KH * G
    q = torch.randn(B, H, S, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, KH, S + 3, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, KH, S + 3, D, generator=g, device=cuda).to(dt)
    n, band = q.numel(), 64 * D
    buf = torch.full((band + n + band,), 1024.0, dtype=dt, device=cuda)
    out = buf[band:band + n].view(B, H, S, D)
    err = fa._lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, KH, S, S + 3, D, 1, fa._DTYPE[dt],
                    torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    torch.cuda.synchronize()
    assert bool((buf[:band] == 1024.0).all())
    assert bool((buf[band + n:] == 1024.0).all())
    want = ref.attention_ref(q, k, v, causal=True)
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


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
@pytest.mark.parametrize("B,H,T,N", [
    (2, 4, 100, 64), (3, 2, 256, 32), (1, 3, 1, 64),
    (8, 32, 256, 64),                    # rwkv6-1.6b's train step
    (2, 3, 300, 64), (2, 3, 300, 32),    # 16-step tiles and a tail
    (1, 2, 32, 64), (2, 2, 64, 32),      # whole tiles only
    (4, 100, 64, 64)])                   # more CTAs than fit at once
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [32, 64])
def test_cuda_wkv6_holds_its_state_where_w_is_1_and_k_is_0(cuda, dt, N):
    """Over steps 40-129 (across tile edges) w = 1 and k = 0: the
    state stays the one after step 39, so there out_t = r_t . S_39 (the
    u-term is 0 with k)."""
    B, H, T = 2, 3, 160
    r, k, v, w, u = wkv_case(cuda, B=B, H=H, T=T, N=N, dtype=dt, seed=N)
    k[:, :, 40:130] = 0
    w[:, :, 40:130] = 1
    got = ops.wkv6(r, k, v, w, u)
    want = ref.wkv6_scan(r, k, v, w, u)
    _, S = ref.wkv6_scan(r[:, :, :40], k[:, :, :40], v[:, :, :40],
                         w[:, :, :40], u, return_state=True)
    held = torch.einsum("bhti,bhij->bhtj", r[:, :, 40:130].float(), S)
    torch.cuda.synchronize()
    tol = WKV_TOL[dt] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(got[:, :, 40:130].float(), held.to(dt).float(),
                               atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_wkv6_takes_unaligned_views(cuda, dt):
    """Contiguous views one element past a 16-byte boundary (staged by
    plain loads, not TMA bulk copies) give what aligned copies give."""
    B, H, T, N = 2, 3, 70, 64
    inputs = wkv_case(cuda, B=B, H=H, T=T, N=N, dtype=dt)
    views = []
    for t in inputs:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    got = ops.wkv6(*views)
    want = ops.wkv6(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wkv6_refuses_what_it_does_not_take(cuda):
    """The wrapper, and the op through it, refuse head size 16, a wrong
    dtype and a layout the kernel does not take."""
    r, k, v, w, u = wkv_case(cuda, B=1, H=2, T=8, N=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan.wkv6_cuda(r, k, v, w, u)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,T", [(8, 16, 1, 128, 1024),
                                        (8, 8, 4, 64, 1024),
                                        (3, 2, 8, 128, 77),
                                        (2, 4, 2, 64, 1)])
def test_cuda_decode_matches_plain(cuda, dt, B, KH, G, D, T):
    """The dense cache (B, T, KH, D) passed transposed, as the engine does;
    ragged kv_len from 1 to T."""
    g = torch.Generator(device=cuda).manual_seed(T + G)
    q = torch.randn(B, KH, G, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, T, KH, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, T, KH, D, generator=g, device=cuda).to(dt)
    kv_len = torch.randint(1, T + 1, (B,), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_len[0] = T
    before = decode_attention.launches["decode_attention"]
    got = ops.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                               kv_len)
    want = ref.decode_attention_ref(q.reshape(B, KH * G, D),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    kv_len).reshape(B, KH, G, D)
    torch.cuda.synchronize()
    assert decode_attention.launches["decode_attention"] == before + 1
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # a scalar kv_len broadcasts to every slot
    got = ops.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), T)
    want = ref.decode_attention_ref(q.reshape(B, KH * G, D),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    T).reshape(B, KH, G, D)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _decode_ref(q, k, v, kv_len):
    """The plain version, with the kernel's (and the TPU kernel's) zeros
    for a slot with no cached token (the plain softmax over an all-masked
    row averages V instead)."""
    B, KH, G, D = q.shape
    want = ref.decode_attention_ref(q.reshape(B, KH * G, D), k, v,
                                    kv_len).reshape(B, KH, G, D)
    return torch.where((kv_len > 0)[:, None, None, None], want,
                       torch.zeros_like(want))


def _decode_case(device, dt, B, KH, G, D, T, lens, pad=0, seed=0):
    """q and a (B, T, KH, D + pad) cache passed transposed (pad > 0: row
    strides that are no multiple of 16 bytes, the element-load path)."""
    g = torch.Generator(device=device).manual_seed(seed + T + G)
    q = torch.randn(B, KH, G, D, generator=g, device=device).to(dt)
    kc = torch.randn(B, T, KH, D + pad, generator=g, device=device).to(dt)
    vc = torch.randn(B, T, KH, D + pad, generator=g, device=device).to(dt)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    return (q, kc[..., :D].transpose(1, 2), vc[..., :D].transpose(1, 2),
            kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("KH,G,D,T,lens,pad", [
    (2, 2, 64, 200, [0, 1, 31, 32, 33, 200], 0),          # zeros, tile edges
    (2, 8, 128, 300, [63, 64, 65, 127, 128, 129, 0, 191, 300], 0),  # ranges
    (4, 4, 64, 1024, [5, 17, 40, 63], 0),        # all shorter than a range
    (4, 2, 64, 1, [1, 0], 0),                                     # T 1
    (2, 16, 128, 4096, [4096, 2500], 0),                          # T 4096
    (2, 32, 64, 100, [100, 50, 1], 0),                       # G * D 2048
    (2, 4, 64, 130, [130, 64, 3], 1),                 # unaligned strides
    (8, 1, 128, 700, [700, 1, 699], 3)], ids=[
        "tiles", "ranges", "short", "T1", "T4096", "G32", "strided",
        "strided-d128"])
def test_cuda_decode_edges(cuda, dt, KH, G, D, T, lens, pad):
    q, k, v, kv_len = _decode_case(cuda, dt, len(lens), KH, G, D, T, lens,
                                   pad)
    got = ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    for b in range(len(lens)):
        if lens[b] == 0:
            assert bool((got[b] == 0).all()), "kv_len 0 must give zeros"
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(got.float(),
                               _decode_ref(q, k, v, kv_len).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_decode_back_to_back_calls(cuda, dt):
    """Calls of different shapes in a row on one stream, then the first
    again, with no synchronization between: a workspace reused too early
    or a combine ticket left set would corrupt a later result."""
    shapes = [(8, 16, 1, 128, 1024, [64, 65, 1024, 241, 267, 87, 110, 71]),
              (3, 8, 8, 128, 4096, [4096, 130, 2049]),
              (8, 8, 4, 64, 1024, [1024, 0, 700, 64, 1, 129, 513, 300])]
    cases = [_decode_case(cuda, dt, B, KH, G, D, T, lens, seed=i)
             for i, (B, KH, G, D, T, lens) in enumerate(shapes)]
    cases.append(cases[0])
    outs = [ops.decode_attention(*c) for c in cases]
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt]
    for c, got in zip(cases, outs):
        torch.testing.assert_close(got.float(), _decode_ref(*c).float(),
                                   atol=tol, rtol=tol)
    torch.testing.assert_close(outs[0], outs[-1], atol=0, rtol=0)


def moe_kernel_case(device, dt, *, B, S, K, E, C, D, seed=0):
    """Routing of distinct top-k experts per token, its slot assignment
    (drops where S * K / E exceeds C), the scatter source and gates."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.rand(B, S, E, generator=g, device=device).topk(K, -1)[1]
    lin, keep = ref.moe_positions(idx, E, C)
    x = torch.randn(B, S, D, generator=g, device=device).to(dt)
    gates = torch.rand(B, S, K, generator=g, device=device)
    gates = gates * keep.reshape(B, S, K)
    return x, idx.to(torch.int32), lin.reshape(B, S, K), gates


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,K,E,C,D", [(8, 1, 8, 64, 8, 2048),
                                         (1, 256, 8, 64, 40, 2048),
                                         (2, 13, 2, 8, 4, 60)])
def test_cuda_moe_scatter_gather_match_plain(cuda, dt, B, S, K, E, C, D):
    x, _, lin, gates = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C,
                                       D=D, seed=S)
    n0 = dict(moe_dispatch.launches)
    buf = moe_dispatch.moe_scatter_cuda(x, lin, E * C)
    torch.testing.assert_close(buf, ref.moe_scatter_ref(x, lin, E * C),
                               atol=0, rtol=0)
    out = torch.randn(B, E * C, D, device=cuda).to(dt)
    out[:, 1::7] = float("nan")        # rows no kept assignment reads
    used = torch.zeros(B, E * C, dtype=torch.bool, device=cuda)
    used.scatter_(1, lin.reshape(B, -1).long().clamp(max=E * C - 1),
                  gates.reshape(B, -1) != 0)
    out = torch.where(used[..., None], out.nan_to_num(), out)
    y = moe_dispatch.moe_gather_cuda(out, lin, gates)
    want = ref.moe_gather_ref(out, lin, gates)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert moe_dispatch.launches == {k: v + 1 for k, v in n0.items()}
    tol = CUDA_TOL[dt]
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_moe_op_matches_plain_and_its_gradient(cuda, dt):
    B, S, K, E, C, D, F = 2, 24, 2, 8, 8, 64, 32
    x, idx, _, _ = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C, D=D)
    g = torch.Generator(device=cuda).manual_seed(1)
    gv = torch.rand(B, S, K, generator=g, device=cuda).to(dt)
    w = [(torch.randn(s, generator=g, device=cuda) / s[1] ** 0.5).to(dt)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    got = ops.moe_dispatch_combine(x, gv, idx, *w, capacity=C)
    want = ref.moe_dense_ref(x, gv, idx, *w, capacity=C)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dt] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if dt != torch.float32:
        return
    inputs = [x, gv, *w]
    gout = torch.randn(B, S, D, generator=g, device=cuda)
    n0 = dict(moe_dispatch.launches)
    out, grads = _grads(lambda a, b, *ws: ops.moe_dispatch_combine(
        a, b, idx, *ws, capacity=C), inputs, gout)
    assert moe_dispatch.launches == {k: v + 1 for k, v in n0.items()}
    ref_out, ref_grads = _grads(lambda a, b, *ws: ref.moe_dense_ref(
        a, b, idx, *ws, capacity=C), inputs, gout)
    for a, b in zip(grads, ref_grads):
        tol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


def _moe_check(x, lin, gates, n_slots, *, nan_rows=True):
    """Scatter bitwise and gather at CUDA_TOL against the plain versions;
    the gather reads expert outputs whose unread rows hold NaN."""
    B, S, D = x.shape
    buf = moe_dispatch.moe_scatter_cuda(x, lin, n_slots)
    want = ref.moe_scatter_ref(x, lin, n_slots)
    out = torch.randn(B, n_slots, D, device=x.device).to(x.dtype)
    if nan_rows:
        used = torch.zeros(B, n_slots, dtype=torch.int32, device=x.device)
        used.scatter_add_(1, lin.reshape(B, -1).long().clamp(max=n_slots - 1),
                          (gates.reshape(B, -1) != 0).int())
        out[used == 0] = float("nan")
    y = moe_dispatch.moe_gather_cuda(out, lin, gates)
    y_want = ref.moe_gather_ref(out, lin, gates)
    torch.cuda.synchronize()
    torch.testing.assert_close(buf, want, atol=0, rtol=0, equal_nan=False)
    assert bool(torch.isfinite(y).all())
    tol = CUDA_TOL[x.dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    return buf, y


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,K,E,C,D", [(8, 1, 8, 64, 8, 2048),
                                         (1, 256, 2, 16, 40, 1024),
                                         (2, 13, 3, 8, 4, 60)])
def test_cuda_moe_scatter_zeroes_a_buffer_that_held_nan(cuda, dt, B, S, K, E,
                                                        C, D):
    """The scatter's buffer comes from ``torch.empty``: a block of the same
    size filled with NaN and freed first is what the caching allocator
    hands it, so a row the kernel fails to write shows."""
    x, _, lin, gates = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C,
                                       D=D, seed=K)
    stale = torch.full((B, E * C + 1, D), float("nan"), dtype=dt,
                       device=cuda)
    ptr = stale.data_ptr()
    del stale
    buf = moe_dispatch.moe_scatter_cuda(x, lin, E * C)
    torch.cuda.synchronize()
    assert buf.data_ptr() == ptr        # the NaN block was reused
    assert bool(torch.isfinite(buf).all())
    torch.testing.assert_close(buf, ref.moe_scatter_ref(x, lin, E * C),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,K,E,C,D", [(2, 2048, 8, 64, 320, 64),
                                         (1, 700, 2, 16, 112, 256),
                                         (8, 256, 8, 64, 40, 32),
                                         (1, 4096, 2, 16, 640, 512)])
@pytest.mark.parametrize("map_min", [0, 1 << 30], ids=["map", "scan"])
def test_cuda_moe_many_assignments(cuda, dt, B, S, K, E, C, D, map_min,
                                   monkeypatch):
    """S*K well past one CTA's 1,024 lin loads a pass (16,384 at the first
    shape), at the chunk, prefill and train shapes' S*K, with the scatter
    made to build its slot map or to scan lin in every CTA; the last shape
    takes the gather's four-warp CTAs."""
    monkeypatch.setattr(moe_dispatch, "SCATTER_MAP_MIN", map_min)
    x, _, lin, gates = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C,
                                       D=D, seed=S)
    _moe_check(x, lin, gates, E * C)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,K,E,C,D", [(8, 1, 8, 64, 8, 256),
                                         (1, 256, 8, 64, 40, 128),
                                         (2, 700, 2, 16, 112, 62)])
def test_cuda_moe_scatter_slot_map_or_scan_ignores_stale_entries(
        cuda, dt, B, S, K, E, C, D):
    """The scatter's two ways to find a slot row's token, each CTA scanning
    lin or a slot map built by a first launch, both bitwise equal to the
    plain version in a NaN-filled buffer; the map here first holds indices
    of real assignments (as a freed map of another call would), which the
    kernel must not trust where lin disagrees."""
    x, _, lin, _ = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C, D=D,
                                   seed=S)
    n_slots = E * C
    want = ref.moe_scatter_ref(x, lin, n_slots)
    g = torch.Generator(device=cuda).manual_seed(1)
    stale = torch.randint(0, S * K, (B, n_slots), generator=g, device=cuda,
                          dtype=torch.int32)
    for slot_map in (None, stale):
        buf = torch.full((B, n_slots + 1, D), float("nan"), dtype=dt,
                         device=cuda)
        err = moe_dispatch._fn("moe_scatter", 4)(
            lin.data_ptr(), x.data_ptr(), buf.data_ptr(),
            None if slot_map is None else slot_map.data_ptr(), B, S, K,
            n_slots, D, moe_dispatch._DTYPE[dt],
            torch.cuda.current_stream().cuda_stream)
        moe_dispatch.build.check(err, "moe_scatter")
        torch.cuda.synchronize()
        torch.testing.assert_close(buf, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_moe_every_assignment_dropped_or_every_slot_filled(cuda, dt):
    """Every lin at the trash slot with zero gates: an all-zero buffer and
    y; then S*K == E*C with each expert taking exactly C tokens: every slot
    row holds a token, only the trash row is zero."""
    B, S, K, E, C, D = 2, 16, 2, 8, 4, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(B, S, D, generator=g, device=cuda).to(dt)
    lin = torch.full((B, S, K), E * C, dtype=torch.int32, device=cuda)
    gates = torch.zeros(B, S, K, device=cuda)
    buf, y = _moe_check(x, lin, gates, E * C)
    assert not bool(buf.any()) and not bool(y.any())
    s = torch.arange(S, device=cuda)
    idx = torch.stack([s % E, (s + E // 2) % E], -1)[None].expand(B, S, K)
    lin, keep = ref.moe_positions(idx.contiguous(), E, C)
    assert bool(keep.all())
    gates = torch.rand(B, S, K, generator=g, device=cuda) + 0.5
    buf, _ = _moe_check(x, lin.reshape(B, S, K), gates, E * C,
                        nan_rows=False)
    assert bool((buf[:, :-1] != 0).any(-1).all())
    assert not bool(buf[:, -1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [61, 62, 64, 2048])
def test_cuda_moe_unaligned_rows_and_views(cuda, dt, D):
    """Rows whose bytes are no multiple of 16 (D 61 and 62) and inputs one
    element off a 16-byte boundary take the one-element paths; a scatter
    into a buffer framed by sentinel bands, itself misaligned, writes every
    row and nothing outside."""
    B, S, K, E, C = 2, 13, 2, 8, 4
    x, _, lin, gates = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C,
                                       D=D, seed=D)
    _moe_check(x, lin, gates, E * C)
    n_slots = E * C
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
        t.shape)
    xs = shift(x)
    assert xs.data_ptr() % 16 != 0 and xs.is_contiguous()
    _moe_check(xs, lin, gates, n_slots)
    n, band = B * (n_slots + 1) * D, 3 * D + 1
    frame = torch.full((band + n + band,), 7.0, dtype=dt, device=cuda)
    buf = frame[band:band + n].view(B, n_slots + 1, D)
    err = moe_dispatch._fn("moe_scatter", 4)(
        lin.data_ptr(), x.data_ptr(), buf.data_ptr(), None, B, S, K, n_slots,
        D, moe_dispatch._DTYPE[dt], torch.cuda.current_stream().cuda_stream)
    moe_dispatch.build.check(err, "moe_scatter")
    torch.cuda.synchronize()
    assert bool((frame[:band] == 7.0).all())
    assert bool((frame[band + n:] == 7.0).all())
    torch.testing.assert_close(buf, ref.moe_scatter_ref(x, lin, n_slots),
                               atol=0, rtol=0)
    out = torch.randn(B, n_slots, D, device=cuda).to(dt)
    outs = shift(out)
    torch.testing.assert_close(
        moe_dispatch.moe_gather_cuda(outs, lin, gates).float(),
        ref.moe_gather_ref(out, lin, gates).float(), atol=CUDA_TOL[dt],
        rtol=CUDA_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("S,D", [(24, 256), (2048, 257)],
                         ids=["warp", "wide"])
def test_cuda_moe_gather_every_k(cuda, dt, K, S, D):
    """The gather's K row loads go out in one exact batch for K 8 and in
    predicated batches of 4 for any other K (K 1, 2, 3 one partial
    batch, K 5 and 9 whole batches and a remainder), with drops and NaN
    in the rows no kept assignment reads; in one-warp CTAs, and (8,192
    tokens, D 257 a unit an element) in four-warp ones."""
    B, E = 4, 16
    C = max(6, S * K // (2 * E))
    x, _, lin, gates = moe_kernel_case(cuda, dt, B=B, S=S, K=K, E=E, C=C,
                                       D=D, seed=K)
    _moe_check(x, lin, gates, E * C)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_moe_back_to_back_and_two_streams(cuda, dt):
    """Shapes in a row on one stream with no synchronization between, then
    two at once on two streams: each result equals its own call's on the
    default stream."""
    shapes = [dict(B=8, S=1, K=8, E=64, C=8, D=2048),
              dict(B=1, S=256, K=2, E=16, C=40, D=1024),
              dict(B=2, S=13, K=3, E=8, C=4, D=62)]
    cases = []
    for i, s in enumerate(shapes):
        x, _, lin, gates = moe_kernel_case(cuda, dt, seed=i, **s)
        out = torch.randn(s["B"], s["E"] * s["C"], s["D"], device=cuda).to(dt)
        cases.append((x, lin, gates, out, s["E"] * s["C"]))
    run = lambda c: (moe_dispatch.moe_scatter_cuda(c[0], c[1], c[4]),
                     moe_dispatch.moe_gather_cuda(c[3], c[1], c[2]))
    outs = [run(c) for c in cases]
    torch.cuda.synchronize()
    for (x, lin, gates, out, n_slots), (buf, y) in zip(cases, outs):
        torch.testing.assert_close(buf, ref.moe_scatter_ref(x, lin, n_slots),
                                   atol=0, rtol=0)
        torch.testing.assert_close(
            y.float(), ref.moe_gather_ref(out, lin, gates).float(),
            atol=CUDA_TOL[dt], rtol=CUDA_TOL[dt])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    both = []
    for st, c in zip(streams, cases[:2]):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            both.append(run(c))
    torch.cuda.synchronize()
    for got, want in zip(both, outs[:2]):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_decode_and_moe_refuse_what_they_do_not_take(cuda):
    """The decode wrapper, and the op through it, refuse head dim 32; a
    layout, dtype or index type the kernels do not take raises too."""
    q = torch.zeros(2, 2, 1, 32, device=cuda)
    kv = torch.zeros(2, 2, 8, 32, device=cuda)
    kv_len = torch.tensor([3, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention.decode_attention_cuda(q, kv, kv, kv_len)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, kv, kv, 3)
    q = torch.zeros(2, 2, 1, 64, device=cuda)
    kv = torch.zeros(2, 2, 64, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous in the head dim"):
        ops.decode_attention(q, kv, kv, 3)
    x = torch.zeros(1, 4, 8, device=cuda, dtype=torch.float64)
    lin = torch.zeros(1, 4, 2, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        moe_dispatch.moe_scatter_cuda(x, lin, 8)
    with pytest.raises(ValueError, match="int32"):
        moe_dispatch.moe_scatter_cuda(x.float(), lin.long(), 8)


def mamba_case(device, *, B, S, di, N, dtype, seed=0, state=True):
    """Scan inputs as the mixer makes them: dt = softplus(...) > 0, A =
    -exp(A_log) with the reference's log(1..N) init plus noise, D near 1,
    dt/x/B/C in ``dtype``, a random float32 initial state."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    dt = torch.nn.functional.softplus(rn(B, S, di) - 2).to(dtype)
    Bm, Cm, x = rn(B, S, N).to(dtype), rn(B, S, N).to(dtype), \
        rn(B, S, di).to(dtype)
    A_log = torch.log(torch.arange(1, N + 1, device=device, dtype=torch.float32)
                      ).expand(di, N) + 0.1 * rn(di, N)
    A = -torch.exp(A_log)
    D = 1 + 0.1 * rn(di)
    h0 = rn(B, di, N) if state else None
    return dt, Bm, Cm, x, A, D, h0


SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("state", [False, True], ids=["stateless", "state"])
@pytest.mark.parametrize("B,S,di,N", [
    (1, 256, 512, 16), (8, 1, 384, 16), (2, 70, 200, 8), (3, 33, 96, 4),
    (1, 256, 16384, 16), (1, 32, 256, 16), (1, 33, 256, 16),
    (1, 2048, 256, 16), (2, 40, 100, 16), (2, 40, 300, 1), (1, 64, 256, 8)])
def test_cuda_mamba_scan_matches_plain(cuda, dt, state, B, S, di, N):
    """Chunk, decode, an uneven S and di with N 8, and N 4; jamba's chunk
    at full width; S one 32-step tile, one tile + 1 and 2048; di not a
    multiple of a CTA's 64 channels (100 in bfloat16 is not whole 16-byte
    rows: the scalar path); N 1 and 8."""
    dt_, Bm, Cm, x, A, D, h0 = mamba_case(cuda, B=B, S=S, di=di, N=N,
                                          dtype=dt, state=state)
    before = mamba_scan.launches["mamba_scan"]
    got, hN = ops.mamba_scan(dt_, Bm, Cm, x, A, D, initial_state=h0,
                             return_state=True)
    if not state:                            # the stateless form too
        y_only = ops.mamba_scan(dt_, Bm, Cm, x, A, D)
        torch.testing.assert_close(y_only, got, atol=0, rtol=0)
    torch.cuda.synchronize()
    assert mamba_scan.launches["mamba_scan"] == before + 1 + (not state)
    want, want_h = ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D, initial_state=h0,
                                      return_state=True)
    assert got.dtype == dt and hN.dtype == torch.float32
    tol = SCAN_TOL[dt] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    tol = 1e-5 * float(want_h.abs().max())
    torch.testing.assert_close(hN, want_h, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_mamba_scan_strided_inputs_and_idle_rows(cuda):
    """B/C as the mixer's split views of one (B, S, r + 2N) tensor, with a
    carried state; rows whose dt is 0 come out with their initial state
    bitwise."""
    dt_, _, _, x, A, D, h0 = mamba_case(cuda, B=4, S=40, di=256, N=16,
                                        dtype=torch.float32)
    dbl = torch.randn(4, 40, 8 + 32, device=cuda)
    _, Bm, Cm = torch.split(dbl, [8, 16, 16], dim=-1)
    dt_[1] = 0
    dt_[3, :] = 0
    want, want_h = ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D, initial_state=h0,
                                      return_state=True)
    got, hN = ops.mamba_scan(dt_, Bm, Cm, x, A, D, initial_state=h0,
                             return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(hN[1], h0[1]) and torch.equal(hN[3], h0[3])
    assert not torch.equal(hN[0], h0[0])
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    torch.testing.assert_close(hN, want_h, atol=1e-5 * float(
        want_h.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_mamba_scan_takes_misaligned_views(cuda, dt):
    """B/C split at a 5-column offset of a (B, S, 5 + 2N) tensor: neither
    their addresses nor their time stride are whole 16-byte units, so the
    kernel stages them by scalar loads.  It must match the plain version,
    keep an idle row's state bitwise, and give what the 16-byte path gives
    on contiguous copies, bit for bit (the same arithmetic)."""
    dt_, _, _, x, A, D, h0 = mamba_case(cuda, B=3, S=70, di=256, N=16,
                                        dtype=dt)
    g = torch.Generator(device=cuda).manual_seed(1)
    dbl = torch.randn(3, 70, 5 + 32, generator=g, device=cuda).to(dt)
    _, Bm, Cm = torch.split(dbl, [5, 16, 16], dim=-1)
    dt_[1] = 0
    assert not mamba_scan.vector_path(dt_, Bm, Cm, x, A, h0)
    got, hN = ops.mamba_scan(dt_, Bm, Cm, x, A, D, initial_state=h0,
                             return_state=True)
    Bc, Cc = Bm.contiguous(), Cm.contiguous()
    assert mamba_scan.vector_path(dt_, Bc, Cc, x, A, h0)
    vy, vh = ops.mamba_scan(dt_, Bc, Cc, x, A, D, initial_state=h0,
                            return_state=True)
    want, want_h = ref.mamba_scan_ref(dt_, Bm, Cm, x, A, D, initial_state=h0,
                                      return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(hN[1], h0[1])
    assert torch.equal(got, vy) and torch.equal(hN, vh)
    tol = SCAN_TOL[dt] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(hN, want_h, atol=1e-5 * float(
        want_h.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,q", [(50, 37), (64, 32), (256, 1), (2, 1)])
def test_cuda_mamba_scan_tail_padding_keeps_the_state_bitwise(cuda, dt, S, q):
    """The mixed step's padding: a row of S steps whose last S - q have
    dt = 0 gives the final state of its first q steps alone, bit for bit,
    and the same y on those q steps."""
    dt_, Bm, Cm, x, A, D, h0 = mamba_case(cuda, B=2, S=S, di=384, N=16,
                                          dtype=dt)
    pad = dt_.clone()
    pad[:, q:] = 0
    y, hN = ops.mamba_scan(pad, Bm, Cm, x, A, D, initial_state=h0,
                           return_state=True)
    first = [t[:, :q].contiguous() for t in (dt_, Bm, Cm, x)]
    yq, hq = ops.mamba_scan(*first, A, D, initial_state=h0,
                            return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(hN, hq)
    assert torch.equal(y[:, :q], yq)


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True], ids=["stateless", "state"])
def test_cuda_mamba_scan_gradient_matches_plain(cuda, state):
    inputs = [t for t in mamba_case(cuda, B=2, S=50, di=64, N=16,
                                    dtype=torch.float32, state=state)
              if t is not None]
    gy = torch.randn(2, 50, 64, device=cuda)
    gh = torch.randn(2, 64, 16, device=cuda)

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in inputs]
        h0 = leaves[6] if state else None
        y, hN = fn(*leaves[:6], chunk=16, initial_state=h0,
                   return_state=True)
        (torch.sum(y * gy) + torch.sum(hN * gh)).backward()
        return [y.detach(), hN.detach()] + [t.grad for t in leaves]

    before = mamba_scan.launches["mamba_scan"]
    got = run(ops.mamba_scan)
    assert mamba_scan.launches["mamba_scan"] == before + 1
    want = run(ref.mamba_scan_ref)
    for a, b in zip(got, want):
        tol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_mamba_scan_refuses_what_it_does_not_take(cuda):
    dt_, Bm, Cm, x, A, D, h0 = mamba_case(cuda, B=1, S=8, di=64, N=16,
                                          dtype=torch.float32)
    big = torch.zeros(1, 8, 17, device=cuda)
    A17 = torch.zeros(64, 17, device=cuda)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan.mamba_scan_cuda(dt_, big, big, x, A17, D)
    with pytest.raises(ValueError, match="state size"):
        ops.mamba_scan(dt_, big, big, x, A17, D)
    with pytest.raises(ValueError, match="all the same"):
        ops.mamba_scan(dt_.bfloat16(), Bm, Cm, x, A, D)
    with pytest.raises(ValueError, match="A must be"):
        ops.mamba_scan(dt_, Bm, Cm, x, A.double(), D)
    with pytest.raises(ValueError, match="last axis"):
        ops.mamba_scan(dt_, Bm, Cm, x.transpose(0, 2).contiguous()
                       .transpose(0, 2), A, D)
    with pytest.raises(ValueError, match="initial_state"):
        ops.mamba_scan(dt_, Bm, Cm, x, A, D, initial_state=h0.bfloat16())


@pytest.mark.cuda
def test_cuda_encdec_matches_the_cpu(cuda):
    """A small encoder-decoder (2 + 2 layers, d 256, 4 heads of 64) on the
    card and on the CPU from the same weights: the training forward's
    logits and gradients' flash launches (the encoder's non-causal, the
    decoder's causal), then a prefill and four lockstep decode steps with
    a scalar position, logits within 1e-4."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import encdec, lm
    arch = dataclasses.replace(configs.get("seamless-m4t-large-v2"),
                               n_layers=2, enc_layers=2, d_model=256,
                               n_heads=4, n_kv_heads=4, d_ff=512, vocab=512)
    params = encdec.init_encdec(arch, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"frames": torch.randn(2, 16, 256, generator=g),
             "tokens": torch.randint(0, 512, (2, 16), generator=g)}
    toks = torch.randint(0, 512, (4, 2, 1), generator=g)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = lm.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, _ = encdec.forward(p, b, arch, remat=False)
            counts = dict(ops.launch_counts())
            cache = encdec.init_cache(arch, 2, 24, torch.float32,
                                      enc_len=16, device=dev)
            lg, cache = encdec.prefill(p, b, cache, arch)
            steps = [lg]
            ops.reset_launch_counts()
            for i, t in enumerate(toks):
                lg, cache = encdec.decode_step(p, t.to(dev), cache, 16 + i,
                                               arch)
                steps.append(lg)
        out[dev.type] = (logits.cpu(), [s.cpu() for s in steps], counts,
                         dict(ops.launch_counts()))
    (gl, gs, gc, gd), (cl, cs, _, _) = out["cuda"], out["cpu"]
    torch.testing.assert_close(gl, cl, atol=1e-4, rtol=1e-4)
    for a, b in zip(gs, cs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert gc["flash_attention"] == 4, gc
    assert gd["decode_attention"] == 2 * 4 and gd["flash_attention"] == 0, gd


@pytest.mark.cuda
def test_cuda_launchers_run_at_their_default_sizes(cuda, tmp_path):
    """The serve command at its default width and depth (llama3.2-1b at its
    published width in 4 layers) and the train command as its docstring
    gives it (``--depth 8``) reach their end on the card through the
    kernels; a width whose heads the kernels do not take (256: head dim 8)
    is refused before anything is built, naming ``--width 0``."""
    from repro_torch.launch import serve, train
    ops.reset_launch_counts()
    out = serve.main(["--requests", "4", "--gen", "4"])
    counts = ops.launch_counts()
    assert len(out["completions"]) == 4
    assert all(len(c.tokens) == 4 for c in out["completions"])
    assert counts["paged_decode_attention"] > 0, counts
    ops.reset_launch_counts()
    hist = train.main(["--arch", "llama3.2-1b", "--depth", "8", "--steps",
                       "2", "--log-every", "1", "--ckpt-every", "0",
                       "--ckpt-dir", str(tmp_path)])
    counts = ops.launch_counts()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert counts["flash_attention"] > 0, counts
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="--width 0"):
        serve.main(["--width", "256", "--requests", "4", "--gen", "4"])
    with pytest.raises(ValueError, match="--width 0"):
        train.main(["--width", "256", "--depth", "8", "--steps", "2",
                    "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert all(v == 0 for v in ops.launch_counts().values())


# --------------------------------------------------------------------------- #
# the dispatcher on the card (kernels/dispatch.py)
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KH,G,D,T,lens", [
    (8, 8, 4, 64, 1024, [1024, 1, 64, 65, 700, 300, 129, 513]),
    (2, 16, 1, 128, 4096, [4096, 2500]),
    (4, 8, 8, 128, 545, [545, 31, 32, 300])], ids=["llama", "long", "jamba"])
def test_cuda_decode_every_tile_candidate_matches_plain(cuda, dt, B, KH, G,
                                                        D, T, lens):
    """Each range per CTA the autotune cache may pick, dense and paged
    (the same tokens through a block table), against the plain version;
    a timing launch (``count=False``) counts no launch."""
    from repro_torch.kernels import dispatch
    q, k, v, kv_len = _decode_case(cuda, dt, B, KH, G, D, T, lens)
    want = _decode_ref(q, k, v, kv_len).float()
    bs = 32
    pages = -(-T // bs)
    pool_k = torch.zeros(B * pages + 1, bs, KH, D, dtype=dt, device=cuda)
    pool_v = torch.zeros_like(pool_k)
    tables = (torch.arange(B * pages, device=cuda, dtype=torch.int32)
              .reshape(B, pages) + 1)
    for b in range(B):
        rows = k[b].transpose(0, 1)                         # (T, KH, D)
        flat_k = torch.zeros(pages * bs, KH, D, dtype=dt, device=cuda)
        flat_v = torch.zeros_like(flat_k)
        flat_k[:T], flat_v[:T] = rows, v[b].transpose(0, 1)
        pool_k[tables[b].long()] = flat_k.reshape(pages, bs, KH, D)
        pool_v[tables[b].long()] = flat_v.reshape(pages, bs, KH, D)
    tol = CUDA_TOL[dt]
    before = ops.launch_counts()
    for (chunk,) in decode_attention.chunk_candidates(B, KH, T):
        got = decode_attention.decode_attention_cuda(
            q, k, v, kv_len, chunk=chunk, count=False)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    for (chunk,) in decode_attention.chunk_candidates(B, KH, pages * bs):
        got = paged_decode_attention.paged_decode_attention_cuda(
            q.contiguous(), pool_k, pool_v, tables, kv_len, chunk=chunk,
            count=False)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    assert ops.launch_counts() == before
    # the dispatcher's tuned call: one launch, the same result
    dispatch.clear_autotune_cache()
    got = ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == (
        before["decode_attention"] + 1)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_dispatch_launches_the_kernel_or_raises(cuda):
    """With no backend named every covered form launches its kernel, and
    a shape the kernel does not take raises (no fallback); a named plain
    backend runs on the card and launches nothing; the carried-state
    WKV6 and the 5-d mixed-step decode run plain."""
    from repro_torch.kernels import dispatch
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k = (torch.randn(1, 4, 16, 64, generator=g, device=cuda)
            for _ in range(2))
    ops.reset_launch_counts()
    want = ref.attention_ref(q, k, k)
    torch.testing.assert_close(ops.flash_attention(q, k, k), want,
                               atol=2e-5, rtol=2e-5)
    assert ops.launch_counts()["flash_attention"] == 1
    for b in dispatch.PLAIN:
        torch.testing.assert_close(ops.flash_attention(q, k, k, backend=b),
                                   want, atol=2e-5, rtol=2e-5)
        with dispatch.force_backend(b):
            ops.flash_attention(q, k, k)
    assert ops.launch_counts()["flash_attention"] == 1
    q8 = torch.randn(1, 4, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim 8"):
        ops.flash_attention(q8, q8, q8)
    r = torch.rand(1, 2, 5, 64, device=cuda)
    u = torch.zeros(2, 64, device=cuda)
    out, state = ops.wkv6(r, r, r, r, u, return_state=True)
    assert state.shape == (1, 2, 64, 64) and ops.launch_counts()["wkv6"] == 0
    ops.wkv6(r, r, r, r, u)
    assert ops.launch_counts()["wkv6"] == 1
    q5 = torch.randn(1, 2, 2, 3, 64, device=cuda)
    kv = torch.randn(1, 2, 9, 64, device=cuda)
    ops.decode_attention(q5, kv, kv, torch.full((1, 3), 9, dtype=torch.int32,
                                                device=cuda))
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.cuda
def test_cuda_tile_autotune_times_on_the_card(cuda, tmp_path, monkeypatch):
    """On CUDA tensors the tile is timed over the candidates and the
    winner persisted; a restart reads it back without re-tuning."""
    from repro_torch.kernels import dispatch
    monkeypatch.setenv(dispatch.ENV_CACHE_DIR, str(tmp_path))
    dispatch.clear_autotune_cache()
    q, k, v, kv_len = _decode_case(cuda, torch.float32, 8, 8, 4, 64, 1024,
                                   [1024] * 8)
    timed = []
    cands = decode_attention.chunk_candidates(8, 8, 1024)
    assert len(cands) > 1
    got = dispatch.tuned_blocks(
        "op_card", ("k",), cands,
        bench=lambda c: timed.append(c) or decode_attention
        .decode_attention_cuda(q, k, v, kv_len, chunk=c, count=False),
        args=(q, k, v, kv_len))
    assert got in cands and set(timed) == {c for (c,) in cands}
    assert dispatch.autotune_cache_stats()["tuned"] == 1
    dispatch.clear_autotune_cache()
    assert dispatch.tuned_blocks("op_card", ("k",), cands, bench=None,
                                 args=(q,)) == got
    assert dispatch.autotune_cache_stats() == {"disk_hits": 1}
    dispatch.clear_autotune_cache()
