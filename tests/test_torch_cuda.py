"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on a machine that has only
PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_wrapper_calls import WRAPPERS, wrapper_call

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
ATTN_CASES = [  # (b, h, hkv, s, t, d), causal; causal only at S == T
    ((1, 2, 2, 64, 64, 32), True), ((1, 2, 2, 64, 64, 32), False),
    ((2, 4, 2, 128, 128, 32), True), ((2, 4, 2, 128, 128, 32), False),
    ((1, 8, 2, 64, 128, 64), False), ((2, 2, 1, 256, 256, 16), True),
    ((1, 32, 2, 64, 64, 128), True), ((1, 32, 2, 512, 512, 128), True),
    ((1, 4, 2, 100, 100, 32), False),    # ragged tiles inside the kernel
    # served prompt lengths: causal inside a ragged tile
    ((1, 32, 2, 9, 9, 128), True), ((1, 32, 2, 67, 67, 128), True),
    ((1, 32, 2, 110, 110, 128), True),
    # zamba2's shared attention: head dim 112 (a masked tail of the 16-wide
    # split), 32 KV heads (group 1), prompts of 17 and 512
    ((1, 32, 32, 17, 17, 112), True), ((1, 32, 32, 512, 512, 112), True),
    ((1, 4, 2, 192, 192, 128), True),     # a ragged number of 128-row blocks
    ((1, 8, 8, 512, 512, 64), True),      # D = 64
    ((1, 4, 2, 64, 320, 32), False),      # T of five 64-key tiles, S of one
    # whisper_medium: the encoder's 1500 frames (off the 64-row tiles), its
    # training decoder's 448 causal rows and their cross-attention
    ((1, 16, 16, 1500, 1500, 64), False), ((1, 16, 16, 448, 448, 64), True),
    ((1, 16, 16, 448, 1500, 64), False),
]
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# the kernel against its own plan (ref.ssd_plan): the same products in
# another order of sums, exp to an ulp, and in bf16 a rounding of y, G or
# B ⊙ w that falls the other way now and then (one bf16 ulp is 2^-8)
PLAN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
SCAN_SHAPES = [  # (b, s, h, p, n, chunk)
    (1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 1, 32, 16, 32),
    (2, 64, 2, 16, 8, 64), (1, 17, 3, 16, 8, 64),
    (1, 256, 4, 64, 64, 128),   # the JAX default chunk of 128 rows
    (1, 96, 2, 16, 8, 96),      # the kernel's chunks: 64 rows, then 32
] + [  # zamba2's prefill: H = 112, P = N = 64, chunk 64, at served lengths
    (b, s, 112, 64, 64, 64) for b in (1, 2) for s in (4, 17, 64, 256, 512)
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", ATTN_CASES)
def test_flash_attention_kernel(cuda_device, shape, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, h, hkv, s, t, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (_rnd(g, dtype, b, n, hh, d) for n, hh in
               ((s, h), (t, hkv), (t, hkv)))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    want = ref.attention_ref(qt, kt, vt, causal=causal)
    _close(flash_attention_fwd(qt, kt, vt, causal=causal), want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [9, 128, 512])
def test_flash_attention_kernel_at_mla_prefill_widths(cuda_device, s, dtype):
    """minicpm3_4b's MLA prefill: q and k [nope | rope] of 96, v of 64, 40
    heads, scale 96^-0.5; k's rope part broadcast to every head and v a
    slice of the decompressed K/V, read through their strides."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = _rnd(g, dtype, 1, s, 40, 96)
    kv = _rnd(g, dtype, 1, s, 40, 128)
    rope = _rnd(g, dtype, 1, s, 1, 32)
    k = torch.cat([kv[..., :64], rope.expand(1, s, 40, 32)], dim=-1)
    v = kv[..., 64:]
    assert not v.is_contiguous()
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=96 ** -0.5)
    _close(ops.flash_attention(q, k, v, scale=96 ** -0.5),
           want.transpose(1, 2), dtype)


@pytest.mark.cuda
def test_flash_attention_refuses_misaligned_input(cuda_device):
    """A bf16 q one element into its storage is 2 bytes off TMA's 16-byte
    alignment: the kernel wrapper raises rather than compute or fall back."""
    from repro_torch.kernels import flash_attention as fa
    n = 1 * 2 * 64 * 32
    q = torch.zeros(n + 1, dtype=torch.bfloat16,
                    device=cuda_device)[1:].view(1, 2, 64, 32)
    kv = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16, device=cuda_device)
    before = fa.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(q, kv, kv)
    assert fa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (2, 4, 2, 128, 32), (1, 8, 8, 256, 64), (3, 4, 1, 512, 16),
    (4, 32, 2, 1024, 128), (2, 4, 2, 256, 256),
    (4, 32, 32, 1024, 112),     # zamba2's decode: D = 112, group 1
    (4, 16, 16, 1024, 128),     # deepseek_moe_16b's decode: 16 heads, MHA
    (2, 16, 2, 512, 64),        # G = 8
    (4, 32, 2, 256, 128),       # T = 256: 8 splits of 32 keys
    (2, 4, 2, 32, 32),          # T = 32: one split, merged in the block
    (1, 64, 1, 512, 64),        # G = 64: two blocks of 32 heads a split
    (2, 4, 2, 128, 20),         # D = 20: bf16 rows off 16 bytes
    (4, 16, 16, 448, 64),       # whisper_medium's self cache: T = 448
    (4, 16, 16, 1500, 64),      # its cross cache: 1500 frames
    (2, 4, 2, 100, 288),        # the widest key and value rows over 256
])
def test_flash_decode_kernel(cuda_device, b, h, hkv, t, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = _rnd(g, dtype, b, 1, h, d)
    k, v = _rnd(g, dtype, b, t, hkv, d), _rnd(g, dtype, b, t, hkv, d)
    kv_len = torch.randint(1, t + 1, (b,), generator=g, device=cuda_device,
                           dtype=torch.int32)
    want = ref.decode_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                          kv_len)
    if d > 256:                  # the value row takes at most 256
        v = v[..., :256]
        want = ref.decode_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                              kv_len)
    _close(ops.flash_decode(q, k, v, kv_len)[:, 0], want, dtype)


def _latent_decode_inputs(dev, dtype, b=4, t=1024, h=40, seed=7):
    """minicpm3_4b's latent decode: a (B, T, 288) cache of [c_kv | k_rope]
    rows as the model lays it out, the key that buffer and the value its
    first 256 columns (a view), and a query of 40 heads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = _rnd(g, dtype, b, t, 288)
    q = _rnd(g, dtype, b, 1, h, 288)
    return q, rows[:, :, None, :], rows[:, :, None, :256]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [(1024, 700, 129, 1), (544, 160, 68, 9),
                                  (32, 33, 64, 1000)])
def test_flash_decode_kernel_at_the_latent_width(cuda_device, lens, dtype):
    """D = 288, Dv = 256, 40 query heads on one KV head (two blocks a
    split, of 32 and 8 heads), the value a view of the key's buffer,
    against ``ref.decode_ref`` at the latent decode's scale (96^-0.5)."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v = _latent_decode_inputs(cuda_device, dtype)
    assert v.data_ptr() == k.data_ptr() and not v.is_contiguous()
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    got = ops.flash_decode(q, k, v, kv_len, scale=96 ** -0.5)
    assert fd.launches == before + 1
    want = ref.decode_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                          kv_len, scale=96 ** -0.5)
    assert got.shape == (4, 1, 40, 256)
    _close(got[:, 0], want, dtype)


@pytest.mark.cuda
def test_flash_decode_refuses_rows_over_its_widths(cuda_device):
    """A key row over 576 or a value row over 512 is refused before a
    launch, and so is a value over 256 that is not a view of the key's
    rows (staged apart, it would pass the block's shared memory)."""
    from repro_torch.kernels import flash_decode as fd
    kv_len = torch.ones(1, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    for d, dv, match in ((584, 512, "576/512"), (576, 520, "576/512"),
                         (576, 512, "shared memory")):
        q = torch.zeros(1, 1, 4, d, device=cuda_device)
        k = torch.zeros(1, 32, 1, d, device=cuda_device)
        v = torch.zeros(1, 32, 1, dv, device=cuda_device)
        with pytest.raises(ValueError, match=match):
            ops.flash_decode(q, k, v, kv_len)
    assert fd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_latent_width_is_one_kernel_and_replays(
        cuda_device, dtype):
    """One ``ops.flash_decode`` call at the latent shape runs one device
    kernel, and replays in a CUDA graph after kv_len and the cache change
    in place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _latent_decode_inputs(cuda_device, dtype)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, kv_len, scale=96 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    events = []
    for _ in range(3):      # a pass may record no device event at all
        if events:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.flash_decode(q, k, v, kv_len, scale=96 ** -0.5)
            torch.cuda.synchronize()
        events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(events) == 1 and "flash_decode" in events[0], events
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, k, v, kv_len, scale=96 ** -0.5)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    for lens in ([9, 68, 160, 544], [1024, 1, 32, 33]):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        k.copy_(_rnd(g, dtype, *k.shape))
        q.copy_(_rnd(g, dtype, *q.shape))
        graph.replay()
        torch.cuda.synchronize()
        _close(out[:, 0], ref.decode_ref(q[:, 0], k.transpose(1, 2),
                                         v.transpose(1, 2), kv_len,
                                         scale=96 ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,dv,causal", [
    (1, 128, 128, 512, 192, 128, True),   # deepseek_v2_236b's MLA prefill
    (1, 128, 128, 9, 192, 128, True),     # a short served prompt
    (1, 4, 2, 67, 192, 128, True),
    (2, 8, 8, 130, 144, 128, True),       # D 144: bf16 pads it to 192
    (1, 4, 4, 64, 192, 64, True),
    (1, 4, 2, 100, 176, 96, False),
])
def test_flash_attention_kernel_at_deepseek_v2_widths(cuda_device, b, h,
                                                      hkv, s, d, dv, causal,
                                                      dtype):
    """D up to 192 and Dv up to 128 (fp32 at 2 ring stages, bf16's unrolled
    Q·Kᵀ over 192 columns), against ``ref.attention_ref`` and the kernel's
    rounding plan, at the model's scale (192^-0.5 for D 192)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k = _rnd(g, dtype, b, s, h, d), _rnd(g, dtype, b, s, hkv, d)
    v = _rnd(g, dtype, b, s, hkv, dv)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=causal).transpose(1, 2)
    _close(got, ref.attention_ref(qt, kt, vt, causal=causal), dtype)
    plan = ref.attention_3xtf32 if dtype == torch.float32 \
        else ref.attention_bf16p
    _close(got, plan(qt, kt, vt, causal=causal), dtype)


def _wide_latent_inputs(dev, dtype, h=128, width=576, seed=9):
    """deepseek_v2_236b's latent decode: a (4, 1024, width) buffer of
    [c_kv | k_rope] rows, the key its first 576 columns and the value its
    first 512 (views), and a query of ``h`` heads; a ``width`` over 576
    puts the rows off the 16-byte loads where it is not a multiple of 16
    bytes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = _rnd(g, dtype, 4, 1024, 1, width)
    return _rnd(g, dtype, 4, 1, h, 576), rows[..., :576], rows[..., :512]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [(1024, 700, 129, 1), (544, 160, 68, 9),
                                  (1024,) * 4, (32, 33, 64, 1000)])
@pytest.mark.parametrize("h,width", [(128, 576), (16, 577), (8, 576),
                                     (3, 580), (2, 576), (1, 576),
                                     (20, 576)])
def test_flash_decode_kernel_at_the_wide_latent_width(cuda_device, h, width,
                                                      lens, dtype):
    """Key 576 and value 512, read once from the key's rows: 16 heads a
    block (128 heads are 8 blocks a split; 20 are 16 + 4), the tensor-core
    path in bf16 at 8-16 heads, the CUDA-core paths below, rows off 16
    bytes; against ``ref.decode_ref`` and the split plan."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v = _wide_latent_inputs(cuda_device, dtype, h, width)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    assert fd.value_in_key(kt, vt)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    got = ops.flash_decode(q, k, v, kv_len, scale=192 ** -0.5)[:, 0]
    assert fd.launches == before + 1
    _close(got, ref.decode_ref(q[:, 0], kt, vt, kv_len, scale=192 ** -0.5),
           dtype)
    heads = fd.plan(dtype, 576, 512, h, True).heads
    split = fd.split_count(1024, fd.groups_of(4, h, 1, 576, 512),
                           fd._sms(cuda_device))
    _close(got, ref.decode_split_ref(
        q[:, 0], kt, vt, kv_len, split, scale=192 ** -0.5,
        round_p=fd.rounds_p(dtype, min(h, heads), 576, 512)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_wide_latent_width_is_one_kernel_and_replays(
        cuda_device, dtype):
    """One ``ops.flash_decode`` call at deepseek_v2_236b's latent shape runs
    one device kernel, and replays in a CUDA graph after kv_len and the
    rows change in place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _wide_latent_inputs(cuda_device, dtype)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, kv_len, scale=192 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    events = []
    for _ in range(3):      # a pass may record no device event at all
        if events:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.flash_decode(q, k, v, kv_len, scale=192 ** -0.5)
            torch.cuda.synchronize()
        events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(events) == 1 and "flash_decode" in events[0], events
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, k, v, kv_len, scale=192 ** -0.5)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    for lens in ([9, 68, 160, 544], [1024, 1, 32, 33]):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        k.copy_(_rnd(g, dtype, *k.shape))
        q.copy_(_rnd(g, dtype, *q.shape))
        graph.replay()
        torch.cuda.synchronize()
        _close(out[:, 0], ref.decode_ref(q[:, 0], k.transpose(1, 2),
                                         v.transpose(1, 2), kv_len,
                                         scale=192 ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_stages_a_separate_value_row_apart(cuda_device, dtype):
    """minicpm3_4b's widths with the value a tensor of its own, not a view
    of the key's rows: K and V each staged, as before the single read."""
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = _rnd(g, dtype, 4, 1, 40, 288)
    k, v = _rnd(g, dtype, 4, 1024, 1, 288), _rnd(g, dtype, 4, 1024, 1, 256)
    assert not fd.value_in_key(k.transpose(1, 2), v.transpose(1, 2))
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    _close(ops.flash_decode(q, k, v, kv_len)[:, 0],
           ref.decode_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                          kv_len), dtype)


# (query, KV) heads of a device in a tensor-parallel mesh step
# (parallel/tensor.py): glm4_9b and llava_next_mistral_7b on a model axis
# of 16, glm4_9b on 4, mistral_large_123b on 16 (a group of 6), deepseek_7b
# on 16
TP_HEADS = [(2, 1), (8, 1), (6, 1), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", TP_HEADS)
def test_attention_kernels_at_tensor_parallel_heads(cuda_device, h, hkv,
                                                    dtype):
    """``ops.flash_attention`` (causal, S = 512) and ``ops.flash_decode``
    (T = 1024, ragged fill) at glm4_9b's D = 128 with the heads a device
    computes in a tensor-parallel step, against the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (_rnd(g, dtype, 2, 512, n, 128) for n in (h, hkv, hkv))
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True)
    _close(ops.flash_attention(q, k, v, causal=True), want.transpose(1, 2),
           dtype)
    q, k, v = _decode_inputs(cuda_device, dtype, 4, h, hkv, 1024, 128)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    _close(ops.flash_decode(q, k, v, kv_len)[:, 0],
           _decode_want(q, k, v, kv_len), dtype)


def _decode_inputs(dev, dtype, b, h, hkv, t, d, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _rnd(g, dtype, b, 1, h, d)
    return q, _rnd(g, dtype, b, t, hkv, d), _rnd(g, dtype, b, t, hkv, d)


def _decode_want(q, k, v, kv_len):
    return ref.decode_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                          kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,t,d", [
    (4, 32, 2, 1024, 128), (4, 32, 32, 1024, 112), (4, 16, 16, 1024, 128),
    (4, 16, 2, 256, 64),
])
def test_flash_decode_kernel_at_split_boundaries(cuda_device, b, h, hkv, t,
                                                 d, dtype):
    """kv_len of 1, at a split boundary, one past it and T, and the same
    against the kernel's split plan (``ref.decode_split_ref``)."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v = _decode_inputs(cuda_device, dtype, b, h, hkv, t, d)
    chunk = t // fd.split_count(t, fd.groups_of(b, h, hkv, d, d), fd._sms(
        cuda_device))
    kv_len = torch.tensor([1, chunk, chunk + 1, t], dtype=torch.int32,
                          device=cuda_device)
    got = ops.flash_decode(q, k, v, kv_len)[:, 0]
    _close(got, _decode_want(q, k, v, kv_len), dtype)
    split = t // chunk
    _close(got, ref.decode_split_ref(
        q[:, 0], k.transpose(1, 2), v.transpose(1, 2), kv_len, split,
        round_p=fd.rounds_p(dtype, h // hkv, d, d)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_ignores_nan_past_kv_len(cuda_device, dtype):
    """NaN in the cache's unwritten tail (a freed slot's rows, say) does
    not reach the result: keys past kv_len are never read into a product."""
    q, k, v = _decode_inputs(cuda_device, dtype, 4, 32, 2, 1024, 128)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    want = ops.flash_decode(q, k, v, kv_len)
    for i, n in enumerate(kv_len.tolist()):
        k[i, n:], v[i, n:] = float("nan"), float("nan")
    got = ops.flash_decode(q, k, v, kv_len)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    _close(got[:, 0], _decode_want(q, k.nan_to_num(), v.nan_to_num(),
                                   kv_len), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_reads_the_model_cache_view(cuda_device, dtype):
    """The model's (B, T, Hkv, D) cache inside a larger pool: K and V are
    interleaved slices of one tensor and the rows a slice of the pool's
    slots, read through their strides with no copy."""
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator(device=cuda_device).manual_seed(5)
    pool = _rnd(g, dtype, 6, 1024, 2, 2, 128)     # slots, T, Hkv, K|V, D
    k, v = pool[1:5, :, :, 0], pool[1:5, :, :, 1]
    assert not k.is_contiguous() and k.data_ptr() != pool.data_ptr()
    q = _rnd(g, dtype, 4, 1, 32, 128)
    kv_len = torch.tensor([544, 160, 68, 9], dtype=torch.int32,
                          device=cuda_device)
    before = fd.launches
    got = ops.flash_decode(q, k, v, kv_len)
    assert fd.launches == before + 1
    _close(got[:, 0], _decode_want(q, k.contiguous(), v.contiguous(),
                                   kv_len), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_replays_in_a_cuda_graph(cuda_device, dtype):
    """One ``ops.flash_decode`` call captured in a CUDA graph and replayed
    after kv_len and the cache change in place: the launch reads kv_len on
    the device, and its grid does not depend on it."""
    q, k, v = _decode_inputs(cuda_device, dtype, 4, 32, 2, 1024, 128)
    kv_len = torch.tensor([1024, 700, 129, 1], dtype=torch.int32,
                          device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, kv_len)          # warm: build, attribute
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, k, v, kv_len)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for lens in ([1024, 700, 129, 1], [9, 68, 160, 544], [0, 1, 32, 33],
                 [1023, 1024, 64, 65]):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        k.copy_(_rnd(g, dtype, *k.shape))
        q.copy_(_rnd(g, dtype, *q.shape))
        graph.replay()
        torch.cuda.synchronize()
        want = _decode_want(q, k, v, kv_len)
        empty = kv_len == 0                         # the kernel gives 0 there
        want[empty] = 0
        _close(out[:, 0], want, dtype)


# the widths with a vector instantiation in csrc/rmsnorm.cu: MLA's kv_norm
# and q_norm, xlstm_125m, whisper_medium, deepseek_moe_16b, minicpm3_4b,
# zamba2_7b, glm4_9b and llava, zamba2's gated norm, 12288
RMSNORM_WIDTHS = (256, 768, 1024, 2048, 2560, 3584, 4096, 7168, 12288)
# deepseek_v2_236b's kv_norm, q_norm and d_model, which take the general path
RMSNORM_GENERAL_WIDTHS = (512, 1536, 5120)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", sorted(
    {(1, 32), (100, 256), (4, 4096), (512, 4096), (3, 12288), (4, 4100),
     (13, 4100), (3, 768), (9, 256)}
    | {(n, d) for d in RMSNORM_WIDTHS + RMSNORM_GENERAL_WIDTHS
       for n in (4, 512)}))
def test_rmsnorm_kernel(cuda_device, n, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x, s = _rnd(g, dtype, n, d), _rnd(g, torch.float32, d)
    _close(ops.fused_rmsnorm(x, s), ref.rmsnorm_ref(x, s), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["columns", "offset", "transposed"])
def test_rmsnorm_kernel_off_the_vector_layout(cuda_device, layout, dtype):
    """``fused_rmsnorm`` on a non-contiguous (4, 4096) view (a column
    slice, a transpose) and on a contiguous one whose storage starts one
    element off a 16-byte boundary (the kernel's general path)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    s = _rnd(g, torch.float32, 4096)
    if layout == "columns":
        x = _rnd(g, dtype, 4, 4096 + 64)[:, 32:4096 + 32]
    elif layout == "transposed":
        x = _rnd(g, dtype, 4096, 4).t()
    else:
        x = _rnd(g, dtype, 4 * 4096 + 1)[1:].view(4, 4096)
        assert x.is_contiguous() and x.data_ptr() % 16
    _close(ops.fused_rmsnorm(x, s), ref.rmsnorm_ref(x, s), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_replays_in_a_cuda_graph(cuda_device, dtype):
    """The kernel captured in a CUDA graph (after the in-place write that
    feeds it), replayed on new inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = _rnd(g, dtype, 4, 4096)
    src, s = torch.empty_like(x), _rnd(g, torch.float32, 4096)
    ops.fused_rmsnorm(x, s)             # built and loaded outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.copy_(src)
        out = ops.fused_rmsnorm(x, s)
    for _ in range(4):
        src.copy_(_rnd(g, dtype, 4, 4096))
        s.copy_(_rnd(g, torch.float32, 4096))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, ref.rmsnorm_ref(src, s), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4, 4096), (512, 7168), (4, 4100)])
def test_rmsnorm_after_an_in_place_write(cuda_device, n, d):
    """An in-place op writes x on the stream and the norm reads it right
    after: every result equals the plain version of the written x."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x, s = _rnd(g, torch.float32, n, d), _rnd(g, torch.float32, d)
    big = _rnd(g, torch.float32, 16, n, d)   # a long write before the norm
    outs, wants = [], []
    for i in range(8):
        x.copy_(big[i])
        x.mul_(1.0 + i).add_(big[i + 8])
        outs.append(ops.fused_rmsnorm(x, s))
        wants.append(ref.rmsnorm_ref(
            big[i] * (1.0 + i) + big[i + 8], s))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        _close(got, want, torch.float32)


def _scan_inputs(gen, dtype, b, s, h, p, n):
    """xh, dt, a_log, B, C drawn as tests/test_kernels.py does; xh, B and
    C are strided slices of one tensor, as the model hands them over."""
    xbc = _rnd(gen, dtype, b, s, h * p + 2 * n)
    xh, bm, cm = torch.split(xbc, [h * p, n, n], -1)
    dt = (_rnd(gen, torch.float32, b, s, h).abs() * 0.1).to(dtype)
    return xh.reshape(b, s, h, p), dt, _rnd(gen, torch.float32, h) * 0.5, \
        bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_mamba_scan_kernel(cuda_device, b, s, h, p, n, chunk, dtype):
    """y and the final state against the sequential oracle, at the SSD
    tolerance of tests/test_kernels.py in fp32 (chunked and sequential sums
    differ in order)."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    g = torch.Generator(device=cuda_device).manual_seed(3)
    args = _scan_inputs(g, dtype, b, s, h, p, n)
    y, state = mamba_scan(*args, chunk=min(chunk, s))
    want_y, want_state = ref.ssd_ref(*args)
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_mamba_scan_kernel_follows_its_plan(cuda_device, b, s, h, p, n,
                                            chunk, dtype):
    """y and the final state against ref.ssd_plan, the kernel's own chunks
    and rounding, at PLAN_TOL: tighter than the gate against the
    sequential oracle."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    g = torch.Generator(device=cuda_device).manual_seed(5)
    args = _scan_inputs(g, dtype, b, s, h, p, n)
    y, state = mamba_scan(*args, chunk=min(chunk, s))
    want_y, want_state = ref.ssd_plan(*args)
    tol = PLAN_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_mamba_scan_shape_contract(cuda_device):
    """N = P = 128 at the JAX default chunk runs (128-row state tiles, P in
    blocks); N over 128 raises ValueError before a launch.  The tiles, not
    the caller's chunk, set the shared memory: 64 rows whatever it is."""
    from repro_torch.kernels import mamba_scan as ms
    limit = torch.cuda.get_device_properties(cuda_device) \
        .shared_memory_per_block_optin
    for dtype in (torch.float32, torch.bfloat16):
        for n in (64, 128):
            for pw in (32, 64):
                assert 0 < ms.smem_bytes(dtype, n, pw) <= limit
    g = torch.Generator(device=cuda_device).manual_seed(4)
    args = _scan_inputs(g, torch.float32, 1, 256, 2, 128, 128)
    y, state = ms.mamba_scan(*args, chunk=128)
    want_y, want_state = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=2e-4)
    wide = _scan_inputs(g, torch.float32, 1, 64, 2, 64, 136)
    before = ms.launches
    with pytest.raises(ValueError, match="N=136"):
        ms.mamba_scan(*wide, chunk=64)
    assert ms.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_does_not_sync(cuda_device, dtype):
    """A zamba2 prefill's scan (S = 512, eight chunks carried through the
    look-back) under sync debug mode "error", where any call that waits
    for the device raises; then again, on the counters the first call left
    at 0, with the same result."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    g = torch.Generator(device=cuda_device).manual_seed(6)
    args = _scan_inputs(g, dtype, 1, 512, 112, 64, 64)
    mamba_scan(*args, chunk=64)           # the counters of this grid exist
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, state = mamba_scan(*args, chunk=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    y2, state2 = mamba_scan(*args, chunk=64)
    want_y, want_state = ref.ssd_plan(*args)
    tol = PLAN_TOL[dtype]
    for got_y, got_state in ((y, state), (y2, state2)):
        torch.testing.assert_close(got_y.float(), want_y.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(got_state, want_state, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_mamba_scan_replays_in_a_cuda_graph(cuda_device):
    """The grid depends on shapes only and every launch leaves its counters
    at 0, so a captured prefill scan replays on new inputs copied in
    place."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    g = torch.Generator(device=cuda_device).manual_seed(7)
    args = _scan_inputs(g, torch.float32, 1, 256, 112, 64, 64)
    new = _scan_inputs(g, torch.float32, 1, 256, 112, 64, 64)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mamba_scan(*args, chunk=64)       # warm: counters and scratch
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, state = mamba_scan(*args, chunk=64)
    for dst, src in zip(args, new):
        dst.copy_(src)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    want_y, want_state = ref.ssd_plan(*new)
    torch.testing.assert_close(y, want_y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(state, want_state, atol=2e-5, rtol=2e-5)


GMM_SHAPES = [  # (e, c, d, f)
    (2, 64, 32, 64), (4, 100, 64, 128), (1, 128, 128, 256), (8, 7, 32, 64),
    (8, 1, 128, 256), (3, 5, 96, 24),     # F under a 4-column group's width
    (1, 130, 256, 128),                   # three C tiles, the last ragged
    # both sides of the streaming/tiled threshold (C <= 8 streams)
    (8, 8, 128, 256), (8, 9, 128, 256),
    # rows of 200 bytes in bf16, which TMA cannot read: C > 8 streams in
    # 8-row chunks (fp32's 400-byte rows take the tiled path, D and F
    # ragged inside their tiles)
    (4, 20, 100, 60),
    # deepseek_moe_16b: decode (C = 1) and prefill at S = 128 and 512
    # (C = 15 and 60 at capacity factor 1.25), gate/up and down
    (64, 1, 2048, 1408), (64, 1, 1408, 2048), (64, 15, 2048, 1408),
    (64, 60, 1408, 2048),
]


def _gmm_inputs(seed, dtype, e, c, d, f, c_alloc=None):
    """x ~ N(0, 1) and w ~ N(0, 1/D), the scale of the model's weights (its
    init is smaller still), so an output is O(1) and fp32 sums of D
    products in two orders stay within the 2e-5 of the other kernels."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _rnd(g, dtype, e, c_alloc or c, d)[:, :c]
    w = (_rnd(g, torch.float32, e, d, f) * d ** -0.5).to(dtype)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_moe_gmm_kernel(cuda_device, e, c, d, f, dtype):
    from repro_torch.kernels.moe_gmm import moe_gmm
    x, w = _gmm_inputs(5, dtype, e, c, d, f)
    out = moe_gmm(x, w)
    assert out.shape == (e, c, f) and out.dtype == dtype
    _close(out, ref.gmm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_reads_a_strided_x(cuda_device, dtype):
    """The model's dispatch buffer without its sink row: rows of stride
    D, experts of stride (C + 1) D."""
    x, w = _gmm_inputs(6, dtype, 16, 9, 256, 384, c_alloc=10)
    assert not x.is_contiguous()
    _close(ops.moe_gmm(x, w), ref.gmm_ref(x, w), dtype)


def _counts(seed, e, c, device):
    """Seeded row counts: expert 0 takes about half of C (a ragged tile),
    expert 1 none, expert 2 all C, expert 3 more than C (clamped); the rest
    are drawn in [0, C + 2]."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, c + 3, (e,), generator=g, dtype=torch.int32)
    for i, n in enumerate((c // 2 + 1, 0, c, c + 5)[:e]):
        rows[i] = n
    return rows.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_moe_gmm_kernel_paths(cuda_device, e, c, d, f, dtype):
    """C <= 8 takes the streaming GEMV and larger C the tiled tensor-core
    path where TMA can read the rows (16-byte multiples), so GMM_SHAPES
    covers both and the fallback."""
    from repro_torch.kernels import moe_gmm as mg
    x, w = _gmm_inputs(5, dtype, e, c, d, f)
    el = x.element_size()
    tma = (d * el) % 16 == 0 and (f * el) % 16 == 0
    assert mg.path(x, w) == ("tiled" if c > 8 and tma else "stream")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_moe_gmm_kernel_with_rows(cuda_device, e, c, d, f, dtype,
                                  monkeypatch):
    """With seeded counts, x's rows past each count NaN (a stale buffer) and
    the output allocated NaN-filled: rows within the count match the plain
    version, and every row past it comes back exactly 0."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    x, w = _gmm_inputs(7, dtype, e, c, d, f)
    rows = _counts(e * 1000 + c, e, c, cuda_device)
    past = torch.arange(c, device=cuda_device)[None, :] \
        >= rows.clamp_max(c)[:, None]
    x = x.masked_fill(past[..., None], float("nan"))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(
        *a, **k).fill_(float("nan")))
    out = moe_gmm(x, w, rows)
    monkeypatch.undo()
    assert out.shape == (e, c, f) and out.dtype == dtype
    assert (out[past] == 0).all()
    _close(out, ref.gmm_ref(x, w, rows), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_with_rows_is_the_same_every_call(cuda_device, dtype):
    """deepseek_moe_16b's prefill at S = 512 (C = 60) with seeded counts,
    100 calls: every one bit-equal to the first and to the plain version's
    tolerance.  Tiles of 17-32 rows read a ring stage that TMA could refill
    before the reads were done, which showed as a wrong tile now and then
    (``python -m repro_torch.launch.gmm_repeats``)."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    e, c, d, f = 64, 60, 1408, 2048
    x, w = _gmm_inputs(7, dtype, e, c, d, f)
    rows = _counts(e * 1000 + c, e, c, cuda_device)
    want, first = ref.gmm_ref(x, w, rows), moe_gmm(x, w, rows)
    _close(first, want, dtype)
    for _ in range(99):
        assert torch.equal(moe_gmm(x, w, rows), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 60])
def test_moe_gmm_kernel_all_zero_rows_returns_zeros(cuda_device, c, dtype):
    """No expert holds a row: every output is 0, even with NaN in x and w,
    since no weight is read and no product is taken."""
    x = torch.full((8, c, 256), float("nan"), dtype=dtype,
                   device=cuda_device)
    w = torch.full((8, 256, 384), float("nan"), dtype=dtype,
                   device=cuda_device)
    rows = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    out = ops.moe_gmm(x, w, rows)
    assert out.shape == (8, c, 384) and (out == 0).all()


@pytest.mark.cuda
def test_moe_gmm_kernel_refuses_bad_rows(cuda_device):
    from repro_torch.kernels import moe_gmm as mg
    before = mg.launches
    x = torch.zeros(2, 4, 128, device=cuda_device)
    w = torch.zeros(2, 128, 128, device=cuda_device)
    for rows in (torch.zeros(2, dtype=torch.int64, device=cuda_device),
                 torch.zeros(3, dtype=torch.int32, device=cuda_device),
                 torch.zeros(2, dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int32, device=cuda_device)[::2]):
        with pytest.raises(ValueError, match="rows"):
            mg.moe_gmm(x, w, rows)
    assert mg.launches == before


@pytest.mark.cuda
def test_moe_gmm_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import moe_gmm as mg
    before = mg.launches
    x = torch.zeros(2, 4, 200, device=cuda_device)
    with pytest.raises(ValueError, match="128"):      # the block contract
        ops.moe_gmm(x, torch.zeros(2, 200, 128, device=cuda_device))
    with pytest.raises(TypeError):
        mg.moe_gmm(x.half(), torch.zeros(2, 200, 128, device=cuda_device,
                                         dtype=torch.float16))
    with pytest.raises(ValueError, match="grouped matmul"):
        mg.moe_gmm(x, torch.zeros(3, 200, 128, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        mg.moe_gmm(x, torch.zeros(2, 128, 200, device=cuda_device).mT)
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gmm(x.cpu(), torch.zeros(2, 200, 128))
    assert mg.launches == before


SLSTM_SHAPES = [  # (b, s, h, dh)
    (2, 32, 3, 8), (1, 64, 2, 16), (2, 48, 1, 8),   # tests/test_kernels.py
    (2, 17, 2, 256),                                # the widest head
    # xlstm_125m (4 heads of 192): prefills of 300 (no multiple of the TPU
    # kernel's 256-step block) and 512 tokens, and a decode tick of 4 slots
    (1, 300, 4, 192), (1, 512, 4, 192), (4, 1, 4, 192),
]


def _slstm_inputs(seed, dtype, b, s, h, dh, scale, prefix=0):
    """xg ~ N(0, 1); r and bias at ``scale`` (0.02 is the model's init of r,
    0.1 lets the recurrence matter more).  With ``prefix``, also the state
    the plain version reaches after ``prefix`` steps of other inputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xg = _rnd(g, dtype, b, s, 4, h, dh)
    r = _rnd(g, torch.float32, 4, h, dh, dh) * scale
    bias = _rnd(g, torch.float32, 4, h, dh) * scale
    state = None
    if prefix:
        state = ref.slstm_seq_ref(_rnd(g, dtype, b, prefix, 4, h, dh), r,
                                  bias)[1]
    return xg, r, bias, state


def _slstm_close(got, want, dtype):
    (h, st), (want_h, want_st) = got, want
    assert h.dtype == dtype and set(st) == {"c", "n", "h", "m"}
    _close(h, want_h, dtype)
    for k in st:
        assert st[k].dtype == torch.float32
        _close(st[k], want_st[k], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.02, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh", SLSTM_SHAPES)
def test_slstm_seq_kernel(cuda_device, b, s, h, dh, dtype, scale):
    """h and the final state against the sequential plain version."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    args = _slstm_inputs(7, dtype, b, s, h, dh, scale)[:3]
    _slstm_close(slstm_seq(*args), ref.slstm_seq_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_seq_kernel_from_a_state(cuda_device, dtype):
    """A decode tick of xlstm_125m (4 slots, S = 1) from a state reached
    after 9 steps, and a run resumed from a middle state equal to the
    whole run."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    xg, r, bias, state = _slstm_inputs(8, dtype, 4, 1, 4, 192, 0.1,
                                       prefix=9)
    assert state["n"].abs().max().item() > 0
    _slstm_close(slstm_seq(xg, r, bias, state),
                 ref.slstm_seq_ref(xg, r, bias, state), dtype)
    xg, r, bias, _ = _slstm_inputs(9, dtype, 2, 40, 4, 192, 0.1)
    whole_h, whole_st = slstm_seq(xg, r, bias)
    head_h, mid = slstm_seq(xg[:, :25].contiguous(), r, bias)
    tail_h, end = slstm_seq(xg[:, 25:].contiguous(), r, bias, mid)
    _slstm_close((torch.cat([head_h, tail_h], dim=1), end),
                 (whole_h, whole_st), dtype)


@pytest.mark.cuda
def test_slstm_seq_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import slstm_cell as sl
    before = sl.launches
    xg, r, bias, state = _slstm_inputs(10, torch.float32, 2, 8, 2, 16, 0.1,
                                       prefix=2)
    with pytest.raises(TypeError):
        sl.slstm_seq(xg.half(), r, bias)
    with pytest.raises(ValueError, match="sLSTM"):
        sl.slstm_seq(xg, r[:, :1], bias)
    for dh in (6, 260):       # not a multiple of 4; over the 256 it takes
        x2, r2, b2, _ = _slstm_inputs(10, torch.float32, 1, 4, 1, dh, 0.1)
        with pytest.raises(ValueError, match="head dim"):
            sl.slstm_seq(x2, r2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        sl.slstm_seq(xg.transpose(0, 1), r, bias)
    with pytest.raises(ValueError, match="state"):
        sl.slstm_seq(xg, r, bias, {k: v[:1] for k, v in state.items()})
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm_seq(xg, r.cpu(), bias)
    with pytest.raises(ValueError, match="S >= 1"):
        ops.slstm_seq(xg[:, :0], r, bias)
    assert sl.launches == before


# the cluster plan's cases: one row, a cluster of 3 rows, two clusters of 3
# and 2; one step (no exchange), two, a short prompt and a long one; a
# one-block cluster (Dh = 4), 8 and 12 blocks of 4 columns (Dh = 32, 48),
# and 16 blocks of 4, 12 and 16 columns (Dh = 64, 192, 256)
PLAN_SHAPES = [(b, s, dh) for b in (1, 3, 5) for s in (1, 2, 17, 300)
               for dh in (4, 32, 48, 64, 192, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,dh", PLAN_SHAPES)
def test_slstm_seq_kernel_over_the_plan(cuda_device, b, s, dh, dtype,
                                        prefix):
    """h and the final state against the plain version, from a zero state
    and from the state ``prefix`` steps of other inputs reach."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    xg, r, bias, state = _slstm_inputs(11, dtype, b, s, 2, dh, 0.1, prefix)
    _slstm_close(slstm_seq(xg, r, bias, state),
                 ref.slstm_seq_ref(xg, r, bias, state), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 17))
def test_slstm_seq_kernel_at_every_cluster_size(cuda_device, cluster):
    """Dh = 4 K, which the plan lays out as a cluster of K blocks of 4
    columns, for every K the card takes: 1 to 8 portable, 9 to 16 not."""
    from repro_torch.kernels import slstm_cell as sl
    dh = 4 * cluster
    assert sl.cluster_plan(2, 4, dh, torch.float32).cluster == cluster
    xg, r, bias, state = _slstm_inputs(12, torch.float32, 2, 33, 4, dh,
                                       0.1, prefix=3)
    _slstm_close(sl.slstm_seq(xg, r, bias, state),
                 ref.slstm_seq_ref(xg, r, bias, state), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,dh,cut", [(1, 192, 1), (5, 64, 16), (3, 256, 9)])
def test_slstm_seq_kernel_resumes_over_the_plan(cuda_device, b, dh, cut,
                                                dtype):
    """A run cut after ``cut`` steps and resumed from its state equals the
    whole run."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    xg, r, bias, _ = _slstm_inputs(13, dtype, b, 17, 3, dh, 0.1)
    whole_h, whole_st = slstm_seq(xg, r, bias)
    head_h, mid = slstm_seq(xg[:, :cut].contiguous(), r, bias)
    tail_h, end = slstm_seq(xg[:, cut:].contiguous(), r, bias, mid)
    _slstm_close((torch.cat([head_h, tail_h], dim=1), end),
                 (whole_h, whole_st), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, 1), (1, 17)])
def test_slstm_seq_replays_in_a_cuda_graph(cuda_device, b, s):
    """One launch captured in a CUDA graph (a decode tick of 4 slots, and a
    short prompt that exchanges h), replayed after xg and the state change
    in place: equal to an eager launch on the new inputs, bit for bit."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    xg, r, bias, state = _slstm_inputs(14, torch.float32, b, s, 4, 192, 0.1,
                                       prefix=9)
    g = torch.Generator(device="cuda").manual_seed(15)
    new_xg = _rnd(g, torch.float32, b, s, 4, 4, 192)
    new_state = ref.slstm_seq_ref(_rnd(g, torch.float32, b, 7, 4, 4, 192),
                                  r, bias)[1]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        slstm_seq(xg, r, bias, state)           # warm: the kernel's attributes
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h, final = slstm_seq(xg, r, bias, state)
    xg.copy_(new_xg)
    for k in state:
        state[k].copy_(new_state[k])
    graph.replay()
    torch.cuda.synchronize()
    want_h, want_st = slstm_seq(xg, r, bias, state)
    assert torch.equal(h, want_h)
    assert all(torch.equal(final[k], want_st[k]) for k in want_st)
    _slstm_close((h, final), ref.slstm_seq_ref(xg, r, bias, state),
                 torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_seq_does_not_sync(cuda_device, dtype):
    """A decode tick from a state and a 64-token prefill under sync debug
    mode "error", where any call that waits for the device raises."""
    from repro_torch.kernels.slstm_cell import slstm_seq
    tick = _slstm_inputs(16, dtype, 4, 1, 4, 192, 0.1, prefix=3)
    prefill = _slstm_inputs(17, dtype, 1, 64, 4, 192, 0.1)
    slstm_seq(*tick)                            # the kernel is built
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [slstm_seq(*args) for args in (tick, prefill)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for args, out in zip((tick, prefill), got):
        _slstm_close(out, ref.slstm_seq_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda_device, name):
    """On the card, a wrapper whose input requires grad under grad mode
    raises, naming its kernel, and launches nothing; under torch.no_grad()
    the same call launches its kernel."""
    call = wrapper_call(name, cuda_device)
    before = ops.launch_counts()[name]
    with pytest.raises(RuntimeError, match=f"CUDA kernel {name} has no "
                                           f"backward"):
        call()
    assert ops.launch_counts()[name] == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1


@pytest.mark.cuda
def test_decode_with_empty_cache_gives_zero(cuda_device):
    """kv_len = 0 gives 0, as the TPU kernel does."""
    q = torch.ones(2, 1, 4, 32, device=cuda_device)
    kv = torch.ones(2, 128, 2, 32, device=cuda_device)
    out = ops.flash_decode(q, kv, kv, torch.zeros(2, dtype=torch.int32,
                                                  device=cuda_device))
    assert out.abs().max().item() == 0.0


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    x = torch.zeros(4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        ops.fused_rmsnorm(x, torch.ones(32, device=cuda_device))
    xh = torch.zeros(1, 16, 2, 8, device=cuda_device, dtype=torch.float16)
    bc = torch.zeros(1, 16, 4, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.mamba_scan(xh, torch.zeros(1, 16, 2, device=cuda_device),
                       torch.zeros(2, device=cuda_device), bc, bc, chunk=16)


@pytest.mark.cuda
def test_model_path_counts_launches(cuda_device):
    """A prefill and a decode step of a small dense model launch each
    kernel as often as the model's structure says."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer as tf
    from repro_torch.models.common import init_params
    cfg = get_config("glm4_9b").reduced().replace(attn_impl="kernel")
    params = init_params(api.param_spec(cfg), torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    ops.reset_launch_counts()
    tokens = torch.arange(16, device=cuda_device)[None]
    logits, cache = tf.lm_prefill(cfg, params, tokens, 64)
    tf.lm_decode(cfg, params, logits.argmax(-1, keepdim=True), cache,
                 torch.tensor([16], dtype=torch.int32, device=cuda_device))
    n = cfg.n_layers
    assert ops.launch_counts() == {"flash_attention": n, "flash_decode": n,
                                   "mamba_scan": 0, "moe_gmm": 0,
                                   "rmsnorm": 2 * (2 * n + 1),
                                   "slstm_seq": 0}


def _to(tree, dev):
    return tree.to(dev) if isinstance(tree, torch.Tensor) else \
        {k: _to(v, dev) for k, v in tree.items()}


@pytest.mark.cuda
def test_hybrid_on_card_matches_cpu_and_counts_launches(cuda_device):
    """Reduced zamba2 (2 groups of 3 Mamba2 layers, both shared attention
    weight sets, 1 rest layer): a 32-token prefill (two SSD chunks) and 4
    decode steps on the card, against the same weights on the CPU, with
    each kernel launched as often as the structure says."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer as tf
    from repro_torch.models.common import init_params
    cfg = get_config("zamba2_7b").reduced().replace(attn_impl="kernel")
    cpu = init_params(api.param_spec(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 32),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda_device):
        params = _to(cpu, dev)
        ops.reset_launch_counts()
        logits, cache = tf.lm_prefill(cfg, params, tokens.to(dev), 64)
        after_prefill = ops.launch_counts()
        kv = torch.tensor([32], dtype=torch.int32, device=dev)
        out = [logits.cpu()]
        for _ in range(4):
            logits, cache = tf.lm_decode(cfg, params,
                                         logits.argmax(-1, keepdim=True),
                                         cache, kv)
            kv += 1
            out.append(logits.cpu())
        runs.append((out, after_prefill, ops.launch_counts(), _to(cache,
                                                                  "cpu")))
    (cpu_out, _, _, cpu_cache), (gpu_out, pre, total, gpu_cache) = runs
    for c, g in zip(cpu_out, gpu_out):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
    for k in ("groups", "attn", "rest"):
        for leaf in cpu_cache[k]:
            torch.testing.assert_close(gpu_cache[k][leaf], cpu_cache[k][leaf],
                                       atol=1e-4, rtol=1e-4)
    n_mamba, n_groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    norms = 2 * n_mamba + 2 * n_groups + 1
    assert pre == {"flash_attention": n_groups, "flash_decode": 0,
                   "mamba_scan": n_mamba, "moe_gmm": 0, "rmsnorm": norms,
                   "slstm_seq": 0}
    assert total == {"flash_attention": n_groups, "flash_decode": 4 * n_groups,
                     "mamba_scan": n_mamba, "moe_gmm": 0,
                     "rmsnorm": 5 * norms, "slstm_seq": 0}


@pytest.mark.cuda
def test_moe_on_card_matches_cpu_and_counts_launches(cuda_device):
    """Reduced deepseek_moe_16b with 16 experts (a decode tick's capacity
    is 1, as at the full model): a 32-token prefill and 4 decode steps of
    3 rows on the card against the same weights on the CPU, with three
    moe_gmm launches per MoE layer and call."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer as tf
    from repro_torch.models.common import init_params
    cfg = get_config("deepseek_moe_16b").reduced().replace(
        attn_impl="kernel", n_experts=16)
    cpu = init_params(api.param_spec(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 32),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda_device):
        params = _to(cpu, dev)
        ops.reset_launch_counts()
        logits, cache = tf.lm_prefill(cfg, params, tokens.to(dev), 64)
        after_prefill = ops.launch_counts()
        kv = torch.full((3,), 32, dtype=torch.int32, device=dev)
        out = [logits.cpu()]
        for _ in range(4):
            logits, cache = tf.lm_decode(cfg, params,
                                         logits.argmax(-1, keepdim=True),
                                         cache, kv)
            kv += 1
            out.append(logits.cpu())
        runs.append((out, after_prefill, ops.launch_counts()))
    (cpu_out, _, _), (gpu_out, pre, total) = runs
    for c, g in zip(cpu_out, gpu_out):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
    n, n_moe = cfg.n_layers, cfg.n_layers - cfg.first_dense
    assert pre == {"flash_attention": n, "flash_decode": 0, "mamba_scan": 0,
                   "moe_gmm": 3 * n_moe, "rmsnorm": 2 * n + 1,
                   "slstm_seq": 0}
    assert total == {"flash_attention": n, "flash_decode": 4 * n,
                     "mamba_scan": 0, "moe_gmm": 5 * 3 * n_moe,
                     "rmsnorm": 5 * (2 * n + 1), "slstm_seq": 0}


@pytest.mark.cuda
def test_xlstm_on_card_matches_cpu_and_counts_launches(cuda_device):
    """Reduced xlstm_125m (3 mLSTM blocks and 1 sLSTM block of 4 heads of
    32): a 40-token prefill and 4 decode steps of 2 rows on the card,
    against the same weights on the CPU, logits and every cache leaf, with
    one slstm_seq launch per sLSTM block and call."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer as tf
    from repro_torch.models.common import init_params
    cfg = get_config("xlstm_125m").reduced().replace(dtype="float32")
    cpu = init_params(api.param_spec(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda_device):
        params = _to(cpu, dev)
        ops.reset_launch_counts()
        logits, cache = tf.lm_prefill(cfg, params, tokens.to(dev), 64)
        after_prefill = ops.launch_counts()
        kv = torch.full((2,), 40, dtype=torch.int32, device=dev)
        out = [logits.cpu()]
        for _ in range(4):
            logits, cache = tf.lm_decode(cfg, params,
                                         logits.argmax(-1, keepdim=True),
                                         cache, kv)
            kv += 1
            out.append(logits.cpu())
        runs.append((out, after_prefill, ops.launch_counts(), _to(cache,
                                                                  "cpu")))
    (cpu_out, _, _, cpu_cache), (gpu_out, pre, total, gpu_cache) = runs
    for c, g in zip(cpu_out, gpu_out):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
    for k in ("mlstm", "slstm"):
        for leaf in cpu_cache[k]:
            torch.testing.assert_close(gpu_cache[k][leaf], cpu_cache[k][leaf],
                                       atol=1e-4, rtol=1e-4)
    n, n_groups = cfg.n_layers, cfg.n_layers // cfg.slstm_every
    assert pre == {"flash_attention": 0, "flash_decode": 0, "mamba_scan": 0,
                   "moe_gmm": 0, "rmsnorm": 2 * n + 1, "slstm_seq": n_groups}
    assert total == {"flash_attention": 0, "flash_decode": 0,
                     "mamba_scan": 0, "moe_gmm": 0,
                     "rmsnorm": 5 * (2 * n + 1), "slstm_seq": 5 * n_groups}


@pytest.mark.cuda
def test_moe_decode_ffn_does_not_sync(cuda_device):
    """The MoE FFN of a decode step at deepseek_moe_16b's routing (64
    experts, top-6, 4 rows) queues its work without waiting for the
    host: any synchronising call raises under sync debug mode "error"."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    spec = moe.moe_spec(256, 64, 128, 2)
    params = init_params(spec, torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    x = torch.randn(4, 1, 256, device=cuda_device)
    want = moe.moe_apply(params, x, 6, capacity_factor=4.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_apply(params, x, 6, capacity_factor=4.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3_4b", "llava_next_mistral_7b",
                                  "whisper_medium"])
def test_new_families_on_card_match_cpu_and_count_launches(cuda_device,
                                                           arch):
    """The reduced MLA, VLM (with image patches) and encoder-decoder models:
    a prefill and 4 greedy decode steps through ``api`` on the card
    against the same weights on the CPU, at 1e-4, with each kernel launched
    as often as the structure says: an MLA block's four norms (its two and
    q_norm, kv_norm), one flash attention a block in prefill and one latent
    flash decode a block a step; Whisper's encoder self-attention, two
    flash decodes (self and cross) a decoder block a step, the BOS step
    included in the prefill."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.parallel.steps import materialize_batch
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             attn_impl="kernel")
    cpu = init_params(api.param_spec(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    batch = materialize_batch(cfg, InputShape("p", 32, 2, "prefill"),
                              seed=1, device="cpu")
    kv0 = 1 if cfg.family == "encdec" else 32
    runs = []
    for dev in ("cpu", cuda_device):
        params = _to(cpu, dev)
        ops.reset_launch_counts()
        logits, cache = api.prefill_fn(cfg, 48)(params, _to(batch, dev))
        pre = ops.launch_counts()
        kv = torch.full((2,), kv0, dtype=torch.int32, device=dev)
        out = [logits.cpu()]
        for _ in range(4):
            logits, cache = api.decode_fn(cfg)(
                params, logits.argmax(-1, keepdim=True), cache, kv)
            kv += 1
            out.append(logits.cpu())
        runs.append((out, pre, ops.launch_counts()))
    (cpu_out, _, _), (gpu_out, pre, total) = runs
    for c, g in zip(cpu_out, gpu_out):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
        assert np.array_equal(g.argmax(-1).numpy(), c.argmax(-1).numpy())
    zero = {"mamba_scan": 0, "moe_gmm": 0, "slstm_seq": 0}
    if cfg.family == "encdec":
        n, nd = cfg.n_layers, cfg.n_dec_layers
        assert pre == {"flash_attention": n, "flash_decode": 2 * nd,
                       "rmsnorm": 2 * n + 1 + 3 * nd + 1, **zero}
        assert total == {"flash_attention": n, "flash_decode": 10 * nd,
                         "rmsnorm": 2 * n + 1 + 5 * (3 * nd + 1), **zero}
        return
    n = cfg.n_layers
    norms = (4 if cfg.attn == "mla" else 2) * n + 1
    assert pre == {"flash_attention": n, "flash_decode": 0,
                   "rmsnorm": norms, **zero}
    assert total == {"flash_attention": n, "flash_decode": 4 * n,
                     "rmsnorm": 5 * norms, **zero}


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda_device):
    """The engine on the card gives the CPU engine's tokens."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    cfg = get_config("glm4_9b").reduced().replace(dtype="float32",
                                                  attn_impl="kernel")
    cpu = init_params(api.param_spec(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 16, 9, 32)]
    outs = []
    for params in (cpu, _to(cpu, cuda_device)):
        eng = ServingEngine(cfg, params, ServeConfig(n_slots=2, cache_len=64))
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        outs.append([r.output for r in sorted(eng.run_until_drained(),
                                              key=lambda r: r.uid)])
    assert outs[0] == outs[1]


# -- the cost model (repro_torch.core) on the card -----------------------------

COST_FIELDS = ("raw_chips", "chip_defects", "raw_package", "package_defects",
               "wasted_kgd")


def _cost_fields(tc):
    return {**{k: getattr(tc.re, k) for k in COST_FIELDS},
            **{f"nre_{k}": getattr(tc.nre, k)
               for k in ("modules", "chips", "packages", "d2d")},
            "total": tc.total}


@pytest.mark.cuda
@pytest.mark.parametrize("flow", ["chip-last", "chip-first"])
@pytest.mark.parametrize("share", [False, True, "groups"])
def test_cost_engine_on_card_matches_cpu(cuda_device, share, flow):
    """engine_bench's 10,000 heterogeneous systems priced on the card and
    on the CPU: every field at the engine's 1e-5 relative."""
    from chip_smoke import make_specs
    from repro_torch import core
    from torch_parity import ENGINE_ATOL, ENGINE_RTOL
    systems = [core.spec(d) for d in make_specs(10_000)]
    mode = [i % 97 for i in range(len(systems))] if share == "groups" \
        else share
    b = core.SystemBatch.from_systems(systems, share_nre=mode,
                                      device=cuda_device)
    engine = core.CostEngine(flow=flow)
    got = _cost_fields(engine.total(b))
    want = _cost_fields(engine.total(b.to("cpu")))
    for k, w in want.items():
        torch.testing.assert_close(got[k].cpu(), w, rtol=ENGINE_RTOL,
                                   atol=ENGINE_ATOL, msg=k)


@pytest.mark.cuda
def test_cost_engine_does_not_sync(cuda_device):
    """RE, NRE and the total queue their work and read nothing back to the
    host, the padded and empty-instance branches included."""
    from repro_torch import core
    specs = [{"kind": "soc", "area": 800.0, "process": "5nm"},
             {"kind": "split", "area": 700.0, "fractions": [0.5, 0.3, 0.2],
              "processes": ["5nm", "7nm", "12nm"], "integration": "2.5D"}]
    batches = [core.SystemBatch.from_specs(specs, share_nre=True,
                                           device=cuda_device),
               core.pad_batch(core.SystemBatch.from_specs(
                   specs[:1], device=cuda_device), n_systems=4,
                   max_chips=3)]
    engine = core.CostEngine()
    want = [engine.total(b).total for b in batches]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [engine.total(b).total for b in batches]
        engine.re(batches[0], flow="chip-first").total
        engine.nre(batches[1]).total
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_cost_model_defaults_to_the_card(cuda_device):
    """Without a device the batch, the engine's results, the sweeps and the
    gradient partitioner are on the GPU, and equal the CPU's."""
    from repro_torch import core
    from repro_torch.core.gradient import optimize_chiplet_count
    from torch_parity import ENGINE_RTOL
    specs = [{"kind": "split", "area": 800.0, "process": "5nm", "n": n,
              "integration": "MCM"} for n in (1, 2, 3)]
    b = core.SystemBatch.from_specs(specs)
    assert b.device.type == "cuda"
    tc = core.CostEngine().total(b)
    assert tc.total.device.type == "cuda"
    cpu = core.CostEngine().total(core.SystemBatch.from_specs(specs,
                                                              device="cpu"))
    torch.testing.assert_close(tc.total.cpu(), cpu.total, rtol=ENGINE_RTOL,
                               atol=0)
    assert core.sweep_partitions("5nm", "MCM", [800.0],
                                 [1, 2])["total"].device.type == "cuda"
    assert core.cost_area_curve("5nm", [100.0])["yield"].device.type == "cuda"
    card = optimize_chiplet_count("5nm", "MCM", 800.0)
    host = optimize_chiplet_count("5nm", "MCM", 800.0, device="cpu")
    assert card.n_rounded == host.n_rounded
    torch.testing.assert_close(card.n_relaxed, host.n_relaxed, rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True])
def test_cost_engine_total_is_the_same_every_call(cuda_device, share):
    """engine_bench's 10,000 systems priced 20 times on the card: every
    field bit-equal to the first call's (the NRE segment sums land in one
    fixed order)."""
    from chip_smoke import make_specs
    from repro_torch import core
    systems = [core.spec(d) for d in make_specs(10_000)]
    b = core.SystemBatch.from_systems(systems, share_nre=share,
                                      device=cuda_device)
    engine = core.CostEngine()
    first = {k: v.cpu() for k, v in _cost_fields(engine.total(b)).items()}
    for call in range(1, 20):
        got = _cost_fields(engine.total(b))
        for k, v in first.items():
            assert torch.equal(got[k].cpu(), v), f"call {call}: {k} differs"


GRAD_CASES = [  # (b, h, hkv, s, d), causal and not at S == T, GQA included
    (1, 2, 2, 64, 32), (2, 4, 2, 128, 32), (1, 8, 2, 64, 64),
    (1, 4, 1, 100, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRAD_CASES)
def test_flash_attention_gradients_on_card_match_the_oracle(
        cuda_device, shape, dtype, causal):
    """ops.flash_attention on the card keeps autograd: the output has a
    grad_fn, and dq, dk, dv equal the CPU oracle's (the JAX package's
    custom VJP differentiates the same oracle)."""
    b, h, hkv, s, d = shape
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(b, s, n, d, generator=g).to(dtype)
               for n in (h, hkv, hkv))
    dout = torch.randn(b, s, h, d, generator=g).to(dtype)
    grads = []
    for dev in ("cpu", cuda_device):
        leaves = [x.to(dev).detach().requires_grad_() for x in (q, k, v)]
        before = ops.launch_counts()["flash_attention"]
        out = ops.flash_attention(*leaves, causal=causal)
        if dev != "cpu":
            assert out.grad_fn is not None
            assert ops.launch_counts()["flash_attention"] == before + 1
        out.backward(dout.to(dev))
        grads.append([x.grad.cpu() for x in leaves])
    for name, want, got in zip("qkv", *grads):
        assert got.dtype == dtype, name
        _close(got, want, dtype)


@pytest.mark.cuda
def test_other_ops_still_refuse_grad_on_card(cuda_device):
    """JAX differentiates no other kernel, so the five other ops raise on
    the card when an input requires grad, as their wrappers do."""
    def t(*shape):
        return torch.randn(*shape, device=cuda_device).requires_grad_()
    calls = {
        "flash_decode": lambda: ops.flash_decode(
            t(1, 1, 2, 16), t(1, 128, 2, 16), t(1, 128, 2, 16),
            torch.full((1,), 100, dtype=torch.int32, device=cuda_device)),
        "mamba_scan": lambda: ops.mamba_scan(
            t(1, 16, 2, 8), t(1, 16, 2), t(2), t(1, 16, 4), t(1, 16, 4),
            chunk=16),
        "moe_gmm": lambda: ops.moe_gmm(t(2, 4, 32), t(2, 32, 64)),
        "rmsnorm": lambda: ops.fused_rmsnorm(t(4, 64), t(64)),
        "slstm_seq": lambda: ops.slstm_seq(t(1, 4, 4, 2, 8), t(4, 2, 8, 8),
                                           t(4, 2, 8)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"CUDA kernel {name} has no "
                                               f"backward"):
            call()


# -- the design-space exploration (repro_torch.dse) on the card ------------

def _dse_bench_space():
    from repro_torch import dse
    return dse.DesignSpace(
        skus=(dse.SKU("laptop", 300.0, 2e6), dse.SKU("desktop", 600.0, 1e6),
              dse.SKU("server", 900.0, 3e5)),
        processes=("5nm", "7nm", "12nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4, 6), allow_reuse=True,
        reuse_package_options=(False, True))


def _arrays_close(got, want, rtol=1e-5):
    import numpy as np
    for f in ("sku_unit_total", "sku_unit_re", "sku_unit_nre",
              "portfolio_cost"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, atol=1e-8, err_msg=f)
    for k in (want.risk or {}):
        np.testing.assert_allclose(got.risk[k], want.risk[k], rtol=rtol,
                                   err_msg=k)
    assert (got.finite == want.finite).all()


@pytest.mark.cuda
def test_prng_on_card_is_the_cpu_stream(cuda_device):
    import numpy as np
    from repro_torch import random as tr
    for seed in (0, 7):
        kc, kg = tr.PRNGKey(seed, "cpu"), tr.PRNGKey(seed, cuda_device)
        for fn in (lambda k: tr.split(k, 5), lambda k: tr.fold_in(k, 3),
                   lambda k: tr.random_bits(k, (33, 7)),
                   lambda k: tr.uniform(k, (1001,)),
                   lambda k: tr.randint(k, (1001,), 0, 19707),
                   lambda k: tr.bernoulli(k, 0.8, (64,)),
                   lambda k: tr.uniform(tr.split(k, 9), (4,))):
            assert torch.equal(fn(kg).cpu(), fn(kc))
        ulp = (tr.normal(kg, (10_000,)).cpu().view(torch.int32).long()
               - tr.normal(kc, (10_000,)).view(torch.int32).long()).abs()
        assert int(ulp.max()) <= 4


@pytest.mark.cuda
def test_dse_sweep_on_card_matches_cpu_and_repeats(cuda_device):
    """All 19,707 candidates of dse_bench's space in chunks of 512: the
    card against the port on the CPU at 1e-5, the same cheapest
    candidate, and a second sweep bit-equal to the first."""
    import numpy as np
    from repro_torch import dse
    sp = _dse_bench_space()
    idx = np.arange(sp.size())
    card = dse.ChunkedEvaluator(sp, candidates_per_chunk=512,
                                device=cuda_device)
    got = card.evaluate_indices(idx)
    want = dse.ChunkedEvaluator(sp, candidates_per_chunk=512,
                                device="cpu").evaluate_indices(idx)
    _arrays_close(got, want)
    assert got.portfolio_cost.argmin() == want.portfolio_cost.argmin()
    again = card.evaluate_indices(idx)
    assert np.array_equal(again.sku_unit_total, got.sku_unit_total)


@pytest.mark.cuda
@pytest.mark.parametrize("mc", [False, True])
def test_dse_sweep_dispatch_does_not_sync(cuda_device, mc):
    """A sweep's chunks queue on the card without one sync, the upload of
    the indices included; only the final copy reads back."""
    import numpy as np
    from repro_torch import dse
    from repro_torch import random as tr
    from repro_torch.dse.evaluate import _to_host
    sp = _dse_bench_space()
    ev = dse.ChunkedEvaluator(sp, candidates_per_chunk=256,
                              device=cuda_device)
    idx = np.random.default_rng(0).integers(0, sp.size(), 1000)
    kw = dict(mc_key=tr.PRNGKey(3, cuda_device), mc_draws=32) if mc else {}
    want = ev.evaluate_indices(idx, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ev.dispatch_indices(idx, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = _to_host(pending)
    assert np.array_equal(got.portfolio_cost, want.portfolio_cost)


@pytest.mark.cuda
def test_dse_search_and_monte_carlo_on_card_match_cpu(cuda_device):
    import numpy as np
    from repro_torch import dse
    from repro_torch import random as tr
    sp = _dse_bench_space()
    kw = dict(population=64, generations=4, elite=8)
    for risk in (None, dse.RiskConfig(n_draws=64, quantile=0.9)):
        got = dse.portfolio_search(sp, tr.PRNGKey(0, cuda_device), risk=risk,
                                   device=cuda_device, **kw)
        want = dse.portfolio_search(sp, tr.PRNGKey(0, "cpu"), risk=risk,
                                    device="cpu", **kw)
        assert got.best.label == want.best.label
        assert [h["best_label"] for h in got.history] == \
            [h["best_label"] for h in want.history]
        assert got.n_evaluated == want.n_evaluated
    idx = np.arange(0, sp.size(), 97)
    key = dict(mc_key=tr.PRNGKey(5, "cpu"), mc_draws=128)
    _arrays_close(dse.ChunkedEvaluator(sp, 128, device=cuda_device)
                  .evaluate_indices(idx, **key),
                  dse.ChunkedEvaluator(sp, 128, device="cpu")
                  .evaluate_indices(idx, **key))


@pytest.mark.cuda
def test_dse_legacy_evaluator_on_card_is_deterministic(cuda_device):
    import numpy as np
    from repro_torch import dse
    sp = _dse_bench_space()
    idx = np.random.default_rng(1).integers(0, sp.size(), 96)
    ev = dse.ChunkedEvaluator(sp, 32, fused=False, device=cuda_device)
    first = ev.evaluate_indices_legacy(idx)
    again = ev.evaluate_indices_legacy(idx)
    assert np.array_equal(first.sku_unit_total, again.sku_unit_total)
    fused = dse.ChunkedEvaluator(sp, 32, device=cuda_device) \
        .evaluate_indices(idx)
    np.testing.assert_allclose(first.portfolio_cost, fused.portfolio_cost,
                               rtol=1e-6)


@pytest.mark.cuda
def test_uneven_split_on_card_matches_cpu(cuda_device):
    from repro_torch.core import optimize_uneven_split
    args = ("5nm", "MCM", [300.0, 200.0, 100.0, 100.0, 100.0], 3)
    got = optimize_uneven_split(*args, device=cuda_device)
    want = optimize_uneven_split(*args, device="cpu")
    assert got["assignment"] == want["assignment"]
    for k in ("soft_cost", "hard_cost"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)


def _service_script(S, size):
    import numpy as np
    rng = np.random.default_rng(11)
    mc = S.McSpec(draws=64, quantiles=(0.5, 0.9), seed=4)
    return [S.PriceRequest(indices=rng.integers(0, size, 700).tolist()),
            S.PriceRequest(indices=rng.integers(0, size, 5).tolist()),
            S.MCRiskRequest(indices=rng.integers(0, size, 40).tolist(),
                            mc=mc),
            S.RankRequest(indices=rng.integers(0, size, 200).tolist(),
                          top_k=4),
            S.WhatIfRequest(base=int(rng.integers(0, size))),
            S.SearchRequest(seed=2, population=32, generations=4, elite=8),
            S.PriceSystemsRequest(specs=(
                {"kind": "soc", "name": "a", "area": 250.0,
                 "process": "7nm", "quantity": 1e6},))]


@pytest.mark.cuda
def test_service_on_card_is_bit_exact_against_the_direct_apis(cuda_device):
    """dse_bench's space served on the card at chunk 128: every response
    equals the port's ChunkedEvaluator / portfolio_search on the card at
    the same chunk shape, bit for bit, and one copy a tick."""
    import numpy as np
    from repro_torch import dse
    from repro_torch import random as tr
    from repro_torch import service as S
    sp = _dse_bench_space()
    cfg = S.ServiceConfig(chunk=128, split=32, warm_mc=((64, (0.5, 0.9)),))
    reqs = _service_script(S, sp.size())
    resps, svc = S.serve(sp, reqs, cfg, device=cuda_device)
    assert all(r.ok for r in resps), [r.error for r in resps]
    ev = dse.ChunkedEvaluator(sp, 128, device=cuda_device)
    for req, r in zip(reqs[:3], resps[:3]):
        kw = {} if req.mc is None else dict(
            mc_key=tr.PRNGKey(req.mc.seed, cuda_device), mc_draws=64,
            mc_quantiles=(0.5, 0.9))
        d = ev.evaluate_indices(np.asarray(req.indices), **kw)
        assert np.array_equal(r.result.sku_unit_total, d.sku_unit_total)
        assert np.array_equal(r.result.portfolio_cost, d.portfolio_cost)
        for k in (d.risk or {}):
            assert np.array_equal(r.result.risk[k], d.risk[k])
    d = ev.evaluate_indices(np.asarray(reqs[3].indices))
    order = np.lexsort((d.idx, d.portfolio_cost))
    assert np.array_equal(resps[3].result.order, d.idx[order])
    grid = svc._what_if_grid(reqs[4])[0]
    assert [row["portfolio_cost"] for row in resps[4].result.rows] == \
        [float(x) for x in ev.evaluate_indices(grid).portfolio_cost[1:]]
    ds = dse.portfolio_search(sp, tr.PRNGKey(2, cuda_device), population=32,
                              generations=4, elite=8, evaluator=ev)
    assert resps[5].result.history == ds.history
    assert [x.portfolio_cost for x in resps[5].result.ranked] == \
        [x.portfolio_cost for x in ds.ranked]
    snap = svc.snapshot()
    assert snap["device_gets"] == snap["ticks"]
    assert snap["recompiles_after_warmup"] == 0
    from repro_torch.obs import torchhooks
    host = torchhooks.to_host(torch.ones(4, device=cuda_device))
    assert host.flags.writeable


@pytest.mark.cuda
def test_service_ticks_run_without_a_sync_before_their_copy(cuda_device):
    """Every tick of a mixed run (chunk, Monte Carlo, search and raw
    lanes) under sync debug mode "error": only the one copy may sync."""
    from repro_torch import service as S
    from repro_torch.obs import torchhooks
    sp = _dse_bench_space()
    cfg = S.ServiceConfig(chunk=128, split=32, warm_mc=((64, (0.5, 0.9)),),
                          warm_search=(S.SearchWarmup(population=32,
                                                      elite=8),))
    real = torchhooks.to_host

    def copy(tree):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    svc = S.PricingService(sp, cfg, device=cuda_device)
    tick = svc._tick

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        torchhooks.to_host = copy
        try:
            return tick()
        finally:
            torchhooks.to_host = real
            torch.cuda.set_sync_debug_mode("default")

    svc._tick = checked
    import asyncio

    async def main():
        await svc.start()
        out = await asyncio.gather(*(svc.submit(r) for r in
                                     _service_script(S, sp.size())))
        await svc.stop()
        return out

    resps = asyncio.run(main())
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert set(svc.snapshot()["ticks_by_lane"]) == {"chunk", "mc", "gen",
                                                    "raw"}


# -- training (repro_torch.parallel.steps) on the card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["glm4_9b", "deepseek_moe_16b", "zamba2_7b",
                                  "xlstm_125m"])
def test_train_steps_on_card_match_cpu_and_count_launches(cuda_device, arch):
    """Three train steps of a reduced model from the same state on the card
    and on the CPU: losses at 1e-5 relative and params at 1e-5 relative
    plus 1% of the lrs' sum (tests/test_torch_train_steps.py says why).
    Each step on the card launches flash attention once a block in the
    forward and once in its remat recompute (the hybrid's shared blocks
    are not remat'd, as in JAX) and no other kernel: norms, MoE experts,
    SSD and sLSTM take the plain route."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch).reduced().replace(attn_impl="kernel")
    cpu = st.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    step = st.make_train_step(cfg, total_steps=3, warmup=1)
    dc = DataConfig(seq_len=32, global_batch=2, vocab=cfg.vocab)
    if cfg.family == "hybrid":
        attn = cfg.n_layers // cfg.attn_every
    else:
        attn = 0 if cfg.family == "ssm" else 2 * cfg.n_layers
    lr_sum = 0.0
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic_batch(dc, i).items()}
        ops.reset_launch_counts()
        card, m_card = step(card, {k: v.to(cuda_device)
                                   for k, v in batch.items()})
        torch.cuda.synchronize()
        assert ops.launch_counts() == {
            "flash_attention": attn, "flash_decode": 0, "mamba_scan": 0,
            "moe_gmm": 0, "rmsnorm": 0, "slstm_seq": 0}
        cpu, m_cpu = step(cpu, batch)
        lr_sum += float(m_cpu["lr"])
        torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"],
                                   rtol=1e-5, atol=0.0)
    for g, c in zip(leaves(card.params), leaves(cpu.params), strict=True):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-5,
                                   atol=1e-2 * lr_sum)


# -- the mesh layer (repro_torch.parallel) on a one-rank NCCL mesh ----------

@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group started
    on a file store under the test's directory."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["glm4_9b", "deepseek_7b"])
def test_sharded_step_on_nccl_matches_unsharded(nccl_mesh, arch):
    """Phase 21(a) and (c) at the reduced config: a sharded step on the
    card equals the unsharded one within 1e-6 of each leaf's max, launches
    flash attention twice a layer and nothing else, and its op count (FLOPs
    and collective bytes) is the dry run's for the same cell."""
    from repro_torch.analysis import hlo
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import dryrun
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    from repro_torch.parallel.comm import AbstractMesh
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             attn_impl="kernel")
    state = st.init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                "cuda")
    copy = tree_map(lambda t: t.clone(), state)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        DataConfig(seq_len=64, global_batch=2, vocab=cfg.vocab), 0).items()}
    plain, m1 = st.make_train_step(cfg, total_steps=5, warmup=1)(copy, batch)
    rules = shd.default_rules()
    lay = st.state_layouts(cfg, nccl_mesh, rules)
    step = st.make_train_step(cfg, total_steps=5, warmup=1, mesh=nccl_mesh,
                              rules=rules)
    ops.reset_launch_counts()
    (got, m2), rep = hlo.count(step, st.shard_state(state, lay), batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "flash_attention": 2 * cfg.n_layers, "flash_decode": 0,
        "mamba_scan": 0, "moe_gmm": 0, "rmsnorm": 0, "slstm_seq": 0}
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0.0)
    for a, b in zip(leaves(got), leaves(plain), strict=True):
        if b.is_floating_point():
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
        else:
            assert torch.equal(a, b)
    cell = dryrun.trace_cell(cfg, InputShape("t", 64, 2, "train"),
                             AbstractMesh((1, 1), ("data", "model")))
    assert cell["hlo_analysis"]["flops"] == rep.flops
    assert cell["hlo_analysis"]["collective_bytes"] == rep.collective_bytes
    assert rep.kernel_calls == {"flash_attention": 2 * cfg.n_layers}


@pytest.mark.cuda
def test_mesh_collectives_on_nccl_match_the_cpu(nccl_mesh):
    """Phase 21(b): flash_decode_shardmap, compressed_psum at k = 1.0 and a
    one-stage pipeline on the card against the plain results on the CPU."""
    import numpy as np
    from repro_torch.parallel.collectives import (_topk_int8_wire,
                                                  compressed_psum,
                                                  flash_decode_shardmap)
    from repro_torch.parallel.pipeline import mlp_stage, pipeline_forward
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((2, 4, 16), (2, 64, 4, 16), (2, 64, 4, 16)))
    got = flash_decode_shardmap(nccl_mesh, "model")(q.cuda(), k.cuda(),
                                                     v.cuda())
    torch.testing.assert_close(got.cpu(), ref.decode_ref(
        q, k.transpose(1, 2), v.transpose(1, 2)), rtol=2e-5, atol=2e-5)
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(64, generator=gen)
    out, err = compressed_psum(nccl_mesh, pod_axis="model",
                               k_fraction=1.0)({"g": g.cuda()},
                                               {"g": torch.zeros(64).cuda()})
    qv, idx, scale = _topk_int8_wire(g, 1.0)
    recon = torch.zeros(64)
    recon[idx] = qv.float() * scale
    torch.testing.assert_close(out["g"].cpu(), recon, rtol=1e-6, atol=1e-7)
    # the residual g - recon is the difference of two numbers of g's size,
    # and the card's reconstruction may round to a float32 next to the
    # CPU's, so the two residuals differ by an ulp or two of |g| (2.4e-7 at
    # |g| in [2, 4)): held at four ulps of max |g| (eps x max |g| is at
    # least one)
    ulps = 4 * torch.finfo(torch.float32).eps * g.abs().max().item()
    torch.testing.assert_close(err["g"].cpu(), g - recon, rtol=1e-6,
                               atol=ulps)
    w = {"w1": torch.randn(1, 16, 16, generator=gen) * 0.3,
         "w2": torch.randn(1, 16, 16, generator=gen) * .3}
    xs = torch.randn(6, 8, 16, generator=gen)
    got = pipeline_forward(mlp_stage, nccl_mesh, "data")(
        {n: t.cuda() for n, t in w.items()}, xs.cuda())
    torch.testing.assert_close(got.cpu(), mlp_stage(
        {n: t[0] for n, t in w.items()}, xs), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_counter_on_the_card_counts_the_traced_route(cuda_device):
    """The op counter over flash attention's kernel forward and its backward
    on the card (run on autograd's device thread) counts what the fake
    tensors' trace counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis import hlo

    def fwd_bwd(q, k, v):
        out = ops.flash_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    shape = (2, 128, 4, 32)
    q, k, v = (torch.randn(shape, device="cuda", requires_grad=True)
               for _ in range(3))
    _, card = hlo.count(fwd_bwd, q, k, v)
    with FakeTensorMode():
        q, k, v = (torch.empty(shape, requires_grad=True) for _ in range(3))
        _, fake = hlo.count(fwd_bwd, q, k, v)
    assert card.flops == fake.flops > 0
    assert card.kernel_calls == fake.kernel_calls == {"flash_attention": 1}
