"""What the port's ops route where: the ``supports_<op>`` predicates of
``repro_torch.kernels.ops`` (pure functions of shapes: what each CUDA
wrapper takes), and the launchers' refusal, on the card, of a model whose
shapes the kernels do not take; and which inputs the selective scan's
kernel moves as 16-byte units (``mamba_scan.vector_path``).

On the card an op whose shapes its kernel does not take raises (held in
``test_torch_cuda.py``); here, on the CPU, every op runs its plain version
at any shape and counts no launch.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    kernel_shape_faults, reduced_arch, require_kernel_shapes)

ATTN = [
    # (q shape, k/v shape, flash takes it, decode takes it)
    ((1, 32, 16, 64), (1, 8, 16, 64), True, True),
    ((2, 16, 7, 128), (2, 16, 9, 128), True, True),
    ((1, 32, 16, 8), (1, 8, 16, 8), False, False),       # head dim 8
    ((1, 4, 5, 32), (1, 4, 5, 32), False, False),        # head dim 32
    ((1, 4, 5, 256), (1, 4, 5, 256), False, False),      # head dim 256
    ((1, 12, 5, 64), (1, 8, 5, 64), False, True),        # H % KH != 0
    ((1, 8, 9, 64), (1, 8, 5, 64), False, True),         # T < S
]


@pytest.mark.parametrize("q,kv,flash,_", ATTN)
def test_supports_flash_attention(q, kv, flash, _):
    assert ops.supports_flash_attention(q, kv) is flash


@pytest.mark.parametrize("G,D,T,want", [
    (4, 64, 1024, True), (1, 128, 1, True), (32, 64, 8, True),
    (16, 128, 8, True), (33, 64, 8, False), (17, 128, 8, False),
    (4, 8, 64, False), (1, 32, 64, False), (1, 64, 0, False)])
def test_supports_decode_attention(G, D, T, want):
    assert ops.supports_decode_attention((8, 8, G, D), (8, 8, T, D)) is want


@pytest.mark.parametrize("G,D,bs,pages,want", [
    (4, 64, 128, 8, True), (1, 128, 16, 64, True), (8, 128, 1, 3, True),
    (32, 64, 128, 1, True), (16, 128, 64, 2, True), (33, 64, 128, 8, False),
    (4, 8, 128, 8, False), (2, 16, 8, 4, False), (4, 64, 128, 0, False)])
def test_supports_paged_decode_attention(G, D, bs, pages, want):
    got = ops.supports_paged_decode_attention(
        (8, 8, G, D), (65, bs, 8, D), (8, pages))
    assert got is want


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 256, 64), True), ((1, 2, 1, 32), True), ((1, 2, 8, 16), False),
    ((1, 2, 8, 128), False), ((0, 2, 8, 64), False), ((1, 2, 0, 64), False)])
def test_supports_wkv6(shape, want):
    assert ops.supports_wkv6(shape) is want


@pytest.mark.parametrize("shape,N,want", [
    ((1, 256, 16384), 16, True), ((8, 1, 512), 1, True), ((1, 8, 64), 17,
                                                           False),
    ((1, 8, 64), 0, False), ((1, 0, 64), 16, False),
    ((65536, 1, 64), 16, False)])
def test_supports_mamba_scan(shape, N, want):
    assert ops.supports_mamba_scan(shape, N) is want


def _scan_views(dtype=torch.float32, *, di=64, N=16, split=0, a_off=0,
                h_off=0, B=2, S=8):
    """dt, Bm, Cm, x, A, h0 as the mixer passes them: B/C split views at
    column ``split`` of one (B, S, split + 2N) tensor (contiguous rows when
    0); A and h0 at an element offset into a larger buffer."""
    dt, x = torch.zeros(B, S, di, dtype=dtype), torch.zeros(B, S, di,
                                                            dtype=dtype)
    dbl = torch.zeros(B, S, split + 2 * N, dtype=dtype)
    _, Bm, Cm = torch.split(dbl, [split, N, N], dim=-1)
    A = torch.zeros(di * N + a_off)[a_off:].view(di, N)
    h0 = torch.zeros(B * di * N + h_off)[h_off:].view(B, di, N)
    return dt, Bm, Cm, x, A, h0


@pytest.mark.parametrize("views,want", [
    (dict(), True), (dict(dtype=torch.bfloat16), True),
    (dict(split=8), True), (dict(split=8, dtype=torch.bfloat16), True),
    (dict(split=512), True),                      # mamba_mix at jamba's rank
    (dict(split=5), False), (dict(split=5, dtype=torch.bfloat16), False),
    (dict(di=100), True), (dict(di=100, dtype=torch.bfloat16), False),
    (dict(N=5), False), (dict(N=8, dtype=torch.bfloat16), True),
    (dict(N=4, dtype=torch.bfloat16), False),
    (dict(a_off=1), False), (dict(h_off=2), False), (dict(a_off=4), True)],
    ids=lambda v: str(v) if isinstance(v, dict) else "")
def test_mamba_scan_vector_path_needs_whole_16_byte_units(views, want):
    """The CUDA kernel stages its tiles by 16-byte copies only where every
    address, stride and row is whole 16-byte units; a view at an odd column
    (or rows of N or di that are not) takes its scalar loads."""
    from repro_torch.kernels import mamba_scan
    dt, Bm, Cm, x, A, h0 = _scan_views(**views)
    assert mamba_scan.vector_path(dt, Bm, Cm, x, A, h0) is want


def test_mamba_scan_vector_path_ignores_the_stride_of_a_length_1_axis():
    """A decode step (S 1) never steps along time, so a time stride that is
    not whole 16-byte units does not send it to the scalar loads; such a
    batch stride (two rows) does."""
    from repro_torch.kernels import mamba_scan
    dt, Bm, Cm, x, A, h0 = _scan_views(S=1)
    x = x.as_strided(x.shape, (x.stride(0), 3, 1))
    assert mamba_scan.vector_path(dt, Bm, Cm, x, A, h0)
    x = x.as_strided(x.shape, (x.stride(0) - 3, 3, 1))
    assert not mamba_scan.vector_path(dt, Bm, Cm, x, A, h0)


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention",
                                "paged_decode_attention", "wkv6",
                                "mamba_scan"])
def test_cpu_tensors_of_unsupported_shapes_run_the_plain_version(op):
    """Shapes no kernel takes, on the CPU: the plain version runs (the
    op's result equals it) and no launch counts."""
    rng = np.random.default_rng(0)
    if op == "flash_attention":
        q, k, v = _rand(rng, 1, 4, 6, 8), _rand(rng, 1, 2, 6, 8), \
            _rand(rng, 1, 2, 6, 8)
        call = lambda: ops.flash_attention(q, k, v, causal=True)
        want = ref.attention_ref(q, k, v, causal=True)
    elif op == "decode_attention":
        q, k, v = _rand(rng, 2, 2, 3, 8), _rand(rng, 2, 2, 9, 8), \
            _rand(rng, 2, 2, 9, 8)
        kv_len = torch.tensor([9, 4], dtype=torch.int32)
        call = lambda: ops.decode_attention(q, k, v, kv_len)
        want = ref.decode_attention_ref(q.reshape(2, 6, 8), k, v,
                                        kv_len).reshape(2, 2, 3, 8)
    elif op == "paged_decode_attention":
        q = _rand(rng, 2, 2, 3, 8)
        kp, vp = _rand(rng, 5, 4, 2, 8), _rand(rng, 5, 4, 2, 8)
        tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
        kv_len = torch.tensor([7, 2], dtype=torch.int32)
        call = lambda: ops.paged_decode_attention(q, kp, vp, tables, kv_len)
        want = ref.paged_decode_attention_ref(q, kp, vp, tables, kv_len)
    elif op == "wkv6":
        r, k, v = (_rand(rng, 1, 2, 5, 16) for _ in range(3))
        w = torch.rand(1, 2, 5, 16)
        u = _rand(rng, 2, 16)
        call = lambda: ops.wkv6(r, k, v, w, u)
        want = ref.wkv6_scan(r, k, v, w, u)
    else:
        dt = torch.rand(1, 5, 6)
        Bm, Cm, x = _rand(rng, 1, 5, 17), _rand(rng, 1, 5, 17), \
            _rand(rng, 1, 5, 6)
        A, D = -torch.rand(6, 17), _rand(rng, 6)
        call = lambda: ops.mamba_scan(dt, Bm, Cm, x, A, D)
        want = ref.mamba_scan_ref(dt, Bm, Cm, x, A, D)
    ops.reset_launch_counts()
    got = call()
    assert all(v == 0 for v in ops.launch_counts().values()), \
        ops.launch_counts()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "jamba-1.5-large-398b",
         "rwkv6-1.6b"]


@pytest.mark.parametrize("name", ARCHS)
def test_published_widths_are_shapes_the_kernels_take(name):
    """The launchers' default width (0: the published one) at the depths
    they are run at on the card."""
    for depth in (0, 2, 4):
        arch = reduced_arch(configs.get(name), 0, depth, 512, 4)
        assert kernel_shape_faults(arch) == []
        require_kernel_shapes(arch, torch.device("cuda"))


@pytest.mark.parametrize("name,width,what", [
    ("llama3.2-1b", 256, "head dim 8,"), ("llama3.2-1b", 128, "head dim 4,"),
    ("olmoe-1b-7b", 256, "head dim 16,"),
    ("jamba-1.5-large-398b", 4096 + 2048, "head dim 96,")])
def test_widths_whose_heads_the_kernels_do_not_take_are_refused(
        name, width, what):
    """On the card the launchers refuse, before building anything, a width
    whose attention heads no kernel takes, and name ``--width 0``; on the
    CPU they take it (every op runs its plain version there)."""
    arch = reduced_arch(configs.get(name), width, 2, 512, 4)
    (fault,) = kernel_shape_faults(arch)
    assert what in fault
    with pytest.raises(ValueError, match="--width 0"):
        require_kernel_shapes(arch, torch.device("cuda"))
    require_kernel_shapes(arch, torch.device("cpu"))


def test_recurrent_sizes_the_kernels_do_not_take_are_refused():
    """rwkv6 keeps its head size 64 at any width (so ``--width 256`` runs
    the kernel); a head size or scan state size outside the kernels'
    range is a fault."""
    rwkv = configs.get("rwkv6-1.6b")
    assert kernel_shape_faults(reduced_arch(rwkv, 256, 2, 512)) == []
    (fault,) = kernel_shape_faults(dataclasses.replace(rwkv,
                                                       rwkv_head_size=16))
    assert "WKV6 head size 16" in fault
    jamba = configs.get("jamba-1.5-large-398b")
    (fault,) = kernel_shape_faults(dataclasses.replace(jamba, ssm_state=17))
    assert "scan state size 17" in fault


def test_a_device_with_no_implementation_raises():
    # a fake XPU tensor: meta tensors stand for the card's (the dry run's)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(1, 2, 4, 64, device="xpu")
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.flash_attention(q, q, q)
