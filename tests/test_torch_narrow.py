"""The narrow kernels' arithmetic (``csrc/narrow.cuh``: K1/K8 and K3 at d 32) on the CPU.

At d_model 32 (TINY_CONFIG, distill's default student, and its tensor-parallel
shards) ``ln_qkv_rope_f32`` / ``_bf16`` (both rope routes) and ``ln_ffn_f32`` /
``_bf16`` run the narrow kernels, whose arithmetic is the FFMA tile product's
that ran there before them, step for step. :func:`emulate_qkv` and
:func:`emulate_ffn` repeat it in plain torch as the kernels take it:

* LayerNorm's two sums in the kernels' lane layout (:func:`ln_sums`: 4 lanes
  a row, lane l columns l + 4j; slots j ^ 4, j ^ 2 and j ^ 1 inside a
  thread, then the lanes l ^ 2 and l ^ 1), bit for bit the warp butterfly
  (lane c column c, xor 16 .. 1) of the FFMA kernels and
  ``gemm_tc.cuh:row_stats`` (:func:`butterfly`);
* each product output one fused multiply-add chain from 0, k ascending
  (:func:`chain`: product and sum in float64, rounded to float32 once), K3's
  second product over the hidden's chunks in order;
* the roundings to the storage type where the kernels round (LayerNorm's
  output, qkv after the bias and after the rope, the hidden after the bias
  and after gelu, every output);
* the kernels' index maps: K1's chunks of 24 rope pairs (thread tx's pairs
  tx + 8e, each column beside its partner D/2 further) and its stores row by
  row (B x L rows in 128-row tiles, a tile's rows past a batch boundary to
  the next example); K3's hidden column tx + 8j in slot 4 tx + j.

rsqrt, tanh, cos and sin are the host's. At tiny's widths, its tp 2 shard
(H 1, d_ff 32) and d 32 at head dim 32, B x L = 2 x 200 (T = 400, not a
multiple of the tile), the emulation holds herro_tpu's Pallas kernels
(``_ln_qkv_rope_pallas`` on both routes, ``_ln_ffn_pallas``) in interpret
mode within 1e-4 in float32 and at ``chip_smoke.compare``'s bf16 bar (4 ulps
at the largest magnitude) in bf16, where it also equals the port's plain
version (``fused._ln_qkv_rope_plain``, ``fused._ln_ffn_plain``) bit for bit,
as the smoke run holds tiny's bf16 rows on the card. The ``gpu`` case holds
each narrow instance against its plain version on the card.
"""

import functools
import signal

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

BF = torch.bfloat16
WIDTH = 32  # narrow.cuh kWidth
PAIRS = 24  # narrow.cuh kPairs: rope pairs a K1 chunk
CHUNK = 32  # narrow.cuh kChunk: hidden columns a K3 chunk
B, L = 2, 200
# tag -> (H, D, d_ff)
WIDTHS = {"tiny": (2, 16, 64), "tiny-tp2": (1, 16, 32), "d32-D32": (1, 32, 64)}


def time_limit(seconds: int):
    """Fail the test with TimeoutError after ``seconds`` (main thread only)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(f"{fn.__name__} exceeded {seconds}s")

            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return wrapper

    return deco


def round_to(t, dtype):
    """float32 values rounded to the storage type, as float32."""
    return t.to(dtype).float()


def butterfly(v):
    """The sums of a warp whose lane c holds column c of v [T, 32] and adds
    lane c ^ o's value for o = 16, 8, 4, 2, 1; every lane's sum, [T, 32]."""
    s = torch.zeros_like(v) + v
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(32) ^ o]
    return s


def ln_sums(v):
    """The same sums as the narrow kernels take them: lane l (of a row's 4)
    holds columns l + 4j in slot j, adds slots j ^ 4, j ^ 2 then j ^ 1, then
    lane l ^ 2 and l ^ 1's sums; every lane's sum, [T, 4]."""
    s = torch.zeros_like(v) + v
    slot = [s[:, [lane + 4 * j for lane in range(4)]] for j in range(8)]
    for o in (4, 2, 1):
        slot = [slot[j] + slot[j + o] for j in range(o)]
    a = slot[0]
    for o in (2, 1):
        a = a + a[:, torch.arange(4) ^ o]
    return a


def layernorm(x, scale, bias, dtype):
    """LayerNorm(x [T, 32]) rounded to ``dtype``, step by step as the kernels
    take it (``layernorm_tile``, ``f32.cuh:ln_apply``)."""
    v = x.float()
    a, a2 = ln_sums(v)[:, :1], ln_sums(v * v)[:, :1]
    mu = a / WIDTH
    var = torch.clamp(a2 / WIDTH - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + 1e-6)
    return round_to((((v - mu) * rstd) * scale) + bias, dtype)


def chain(a, w):
    """a [T, K] @ w [K, N], each output one fused multiply-add chain from 0
    over k ascending: the product and the sum in float64 (the product exact),
    rounded to float32."""
    ad, wd = a.double(), w.double()
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float64)
    for k in range(a.shape[1]):
        acc = (ad[:, k:k + 1] * wd[k] + acc).float().double()
    return acc.float()


def gelu_tanh(x):
    """f32.cuh:gelu_tanh, each step in float32."""
    beta = torch.tensor(0.7978845608028654, dtype=torch.float32)
    kappa = torch.tensor(0.044715, dtype=torch.float32)
    cube = (x * x) * x
    return (0.5 * x) * (1.0 + torch.tanh(beta * (x + kappa * cube)))


def pair_col(p: int, half: int) -> int:
    """narrow.cuh:pair_col: pair p's first-half column of qkv."""
    return p // half * 2 * half + p % half


def qkv_slots(H: int, D: int) -> list[int]:
    """The qkv column in each slot of K1's chunks, in chunk order: slot 6 tx
    + 2e + part of chunk c holds pair 24c + tx + 8e's first-half column
    (part 0) or its partner (part 1)."""
    half = D // 2
    return [pair_col(PAIRS * c + s // 6 + 8 * (s % 6 // 2), half) + s % 2 * half
            for c in range(H * D // 16) for s in range(2 * PAIRS)]


def ffn_slots(f: int) -> list[int]:
    """The hidden column in each slot of K3's chunks: tx + 8j at 4 tx + j."""
    return [CHUNK * c + s // 4 + 8 * (s % 4) for c in range(f // CHUNK) for s in range(CHUNK)]


def rope_tables(n: int, D: int, route: str):
    """cos/sin [n, D/2]: the tables the wrapper hands K1, or those K8 builds
    (the plain version's expression)."""
    if route == "tbl":
        return fused.rope_tables(n, D, "cpu")
    half = D // 2
    ri = torch.arange(half, dtype=torch.float32)
    freq = torch.exp(torch.tensor(-9.210340371976184, dtype=torch.float32) * ri / half)
    ang = torch.arange(n, dtype=torch.float32)[:, None] * freq
    return torch.cos(ang), torch.sin(ang)


def emulate_qkv(x, scale, bias, w, b, H: int, route: str = "tbl"):
    """K1 (``route`` "tbl") or K8 ("split") at d 32 as the narrow kernel
    computes and stores it: q, k, v [B, H, L, D] of x's dtype."""
    dtype = x.dtype
    nb, n, d = x.shape
    D = w.shape[1] // (3 * H)
    half, T = D // 2, nb * n
    cols = qkv_slots(H, D)
    assert sorted(cols) == list(range(3 * H * D))  # exactly N columns
    a = layernorm(x.reshape(T, d), scale, bias, dtype)
    acc = chain(a, w.float()[:, cols])
    acc = round_to(acc + b.float()[cols], dtype)  # qkv_bias, in slot order
    cos, sin = rope_tables(n, D, route)
    rows = torch.arange(T)
    ls = rows % n
    base = ((rows // n) * H * n + ls) * D  # (b, head 0, l) in q/k/v
    out = torch.full((3, nb * H * n * D), float("nan"))
    for c in range(H * D // 16):
        for tx in range(8):
            for e in range(3):
                p = PAIRS * c + tx + 8 * e
                head, ri = p // half, p % half
                which = head // H
                s1 = 2 * PAIRS * c + 6 * tx + 2 * e
                x1, x2 = acc[:, s1], acc[:, s1 + 1]
                if which < 2:
                    cs, sn = cos[ls, ri], sin[ls, ri]
                    x1, x2 = (round_to(x1 * cs - x2 * sn, dtype),
                              round_to(x2 * cs + x1 * sn, dtype))
                at = base + (head - which * H) * n * D + ri
                out[which, at] = x1
                out[which, at + half] = x2
    assert not bool(out.isnan().any())  # every output stored
    return tuple(out[i].reshape(nb, H, n, D).to(dtype) for i in range(3))


def emulate_ffn(x, scale, bias, w1, b1, w2, b2):
    """K3 at d 32 as the narrow kernel computes it: out of x's shape and dtype."""
    dtype = x.dtype
    d, f = x.shape[-1], w1.shape[1]
    xf = x.reshape(-1, d).float()
    cols = ffn_slots(f)
    assert sorted(cols) == list(range(f))
    a = layernorm(xf, scale, bias, dtype)
    h = round_to(chain(a, w1.float()[:, cols]) + b1.float()[cols], dtype)
    h = round_to(gelu_tanh(h), dtype)
    ht = torch.empty_like(h)
    ht[:, cols] = h  # ht's rows in hidden order: the second product's k
    o = chain(ht, w2.float())
    return round_to(xf + (o + b2.float()), dtype).to(dtype).reshape(x.shape)


def _t(a, dtype=torch.float32, dev="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).to(dev)


def _inputs(seed: int, H: int, D: int, f: int, dtype, nb: int = B, n: int = L, dev="cpu"):
    """x, LayerNorm's scale and bias, W_qkv, b_qkv, W1, b1, W2, b2 as the
    smoke run draws them; the weights and x of ``dtype``."""
    rng = np.random.default_rng(seed)
    d = WIDTH

    def t(*shape, std=1.0, mean=0.0, dt=dtype):
        return _t(rng.normal(mean, std, size=shape), dt, dev)

    return (t(nb, n, d), t(d, std=0.1, mean=1.0, dt=torch.float32),
            t(d, std=0.1, dt=torch.float32), t(d, 3 * H * D, std=d ** -0.5),
            t(3 * H * D, std=0.25), t(d, f, std=d ** -0.5), t(f, std=0.25),
            t(f, d, std=f ** -0.5), t(d, std=0.25))


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return jnp, pltpu, jfused


def _jax(jnp, t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == BF \
        else jnp.asarray(t.numpy())


def _held(got, want, dtype):
    """float32 within 1e-4; bf16 within 2^-6 of the largest output (4 bf16
    ulps, chip_smoke.compare's bar)."""
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(np.asarray(w, dtype=np.float32) for w in (want if isinstance(want, tuple)
                                                            else (want,)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        bar = 1e-4 if dtype == torch.float32 else float(np.abs(w).max()) * 2.0 ** -6
        assert float(np.abs(g.float().numpy() - w).max()) <= bar


def test_lane_layout_sums_as_the_warp_butterfly():
    """Slots j ^ 4, j ^ 2, j ^ 1, then lanes xor 2, 1 meet the same pairs as
    the butterfly over 32 lanes: equal sums, for x and for x^2, on every
    lane."""
    rng = np.random.default_rng(3)
    v = _t(rng.normal(0.3, 2.0, size=(4096, WIDTH)))
    for t in (v, v * v):
        want = butterfly(t)
        assert bool((want == want[:, :1]).all())
        assert torch.equal(ln_sums(t), want[:, :4])


@pytest.mark.parametrize("H,D", [(2, 16), (1, 16), (1, 32), (1, 64), (2, 128)])
def test_qkv_chunks_hold_whole_pairs_and_runs_of_one_head(H, D):
    """H D / 16 chunks of 24 pairs take every column of qkv once, each beside
    its partner D/2 further; the 8 lanes of a row hold 8 consecutive first-half
    dims of one head (one run of a row in q, k or v)."""
    half = D // 2
    cols = qkv_slots(H, D)
    assert sorted(cols) == list(range(3 * H * D))
    assert all(cols[s + 1] == cols[s] + half for s in range(0, len(cols), 2))
    for c in range(H * D // 16):
        for e in range(3):
            ps = [PAIRS * c + tx + 8 * e for tx in range(8)]
            assert len({p // half for p in ps}) == 1
            assert [p % half for p in ps] == list(range(ps[0] % half, ps[0] % half + 8))


@time_limit(60)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["tbl", "split"])
@pytest.mark.parametrize("tag", sorted(WIDTHS))
def test_emulated_qkv_holds_pallas_interpret(tag, route, dtype, ref):
    jnp, pltpu, jfused = ref
    H, D, f = WIDTHS[tag]
    dt = getattr(torch, dtype)
    x, s, b, w, bias, *_ = _inputs(31, H, D, f, dt)
    got = emulate_qkv(x, s, b, w, bias, H, route)
    assert all(g.dtype == dt and g.shape == (B, H, L, D) for g in got)
    with pltpu.force_tpu_interpret_mode():
        want = jfused._ln_qkv_rope_pallas(*(_jax(jnp, a) for a in (x, s, b, w, bias)), H,
                                          blk_t=L, rope_tbl=route == "tbl")
    _held(got, want, dt)
    if dt == BF:  # the bits the smoke run holds tiny's bf16 rows to on the card
        plain = fused._ln_qkv_rope_plain(x, s, b, w, bias, H)
        assert all(torch.equal(g, p) for g, p in zip(got, plain))


@time_limit(60)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", sorted(WIDTHS))
def test_emulated_ffn_holds_pallas_interpret(tag, dtype, ref):
    jnp, pltpu, jfused = ref
    H, D, f = WIDTHS[tag]
    dt = getattr(torch, dtype)
    x, s, b, _, _, w1, b1, w2, b2 = _inputs(37, H, D, f, dt)
    got = emulate_ffn(x, s, b, w1, b1, w2, b2)
    assert got.dtype == dt and got.shape == x.shape
    args = (x.reshape(-1, WIDTH), s, b, w1, b1, w2, b2)
    with pltpu.force_tpu_interpret_mode():
        want = jfused._ln_ffn_pallas(*(_jax(jnp, a) for a in args), blk_t=L)
    _held(got.reshape(-1, WIDTH), want, dt)
    if dt == BF:
        assert torch.equal(got, fused._ln_ffn_plain(x, s, b, w1, b1, w2, b2))


def test_narrow_width_is_the_kernels():
    """The wrappers' NARROW_D_MODEL is narrow.cuh's kWidth, and the four
    entry sources send d_model up to it there."""
    import os

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "herro_tpu_torch", "csrc")
    with open(os.path.join(csrc, "narrow.cuh")) as fh:
        assert f"constexpr int kWidth = {fused.NARROW_D_MODEL};" in fh.read()
    for name in ("ln_qkv_rope_f32", "ln_qkv_rope_bf16", "ln_ffn_f32", "ln_ffn_bf16"):
        with open(os.path.join(csrc, f"{name}.cu")) as fh:
            text = fh.read()
        assert '#include "narrow.cuh"' in text
        assert text.count("if (d <= herro::narrow::kWidth)") == text.count('extern "C"')


# widths on the card: tiny, its shard, d 32 at head dim 32, and one whose
# chunks outnumber narrow.cuh kResident (the weights staged chunk by chunk)
GPU_WIDTHS = [(2, 16, 64), (1, 16, 32), (1, 32, 64), (1, 64, 128)]
GPU_IDS = [f"H{h}-D{dd}-f{f}" for h, dd, f in GPU_WIDTHS]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(fn):
    before = kernels.launch_counts.snapshot()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", GPU_WIDTHS, ids=GPU_IDS)
def test_narrow_kernels_match_plain_on_card(width, dtype):
    """Each narrow instance, one launch, at B x L = 3 x 1000 (tiles across
    batch boundaries, a last tile of 56 rows): float32 within 1e-4, bf16
    equal to the plain version bit for bit (at the widths the smoke run holds
    so; the restaged width at the bf16 bar), K8 equal to K1."""
    dev = _card()
    H, D, f = width
    dt = getattr(torch, dtype)
    sfx = "f32" if dt == torch.float32 else "bf16"
    exact = dt == BF and width != GPU_WIDTHS[-1]
    x, s, b, w, bias, w1, b1, w2, b2 = _inputs(41, H, D, f, dt, nb=3, n=1000, dev=dev)

    def held(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, r in zip(got, want):
            assert g.dtype == dt and g.shape == r.shape
            if exact:
                assert torch.equal(g, r)
            else:
                bar = 1e-4 if dt == torch.float32 else float(r.float().abs().max()) * 2.0 ** -6
                assert float((g.float() - r.float()).abs().max()) <= bar

    outs = {}
    for route in (f"ln_qkv_rope_{sfx}", f"ln_qkv_rope_{sfx}_split"):
        outs[route], launched = _launched(
            lambda r=route: fused._ln_qkv_rope_cuda(x, s, b, w, bias, H, kernel=r))
        assert launched == {route: 1}
        held(outs[route], fused._ln_qkv_rope_plain(x, s, b, w, bias, H))
    assert all(torch.equal(p, q) for p, q in zip(*outs.values()))
    name = f"ln_ffn_{sfx}"
    got, launched = _launched(lambda: fused._ln_ffn_cuda(x, s, b, w1, b1, w2, b2, kernel=name))
    assert launched == {name: 1}
    held(got, fused._ln_ffn_plain(x, s, b, w1, b1, w2, b2))


def test_clock_tool_plants_its_laps_in_a_copy_of_the_sources():
    """``tools/narrow_clocks_torch.py`` finds each of its anchors in
    narrow.cuh as often as it expects, laps every phase and flushes both
    kernels' counters."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "narrow_clocks_torch", os.path.join(root, "tools", "narrow_clocks_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(root, "herro_tpu_torch", "csrc", "narrow.cuh")) as fh:
        text = fh.read()
    planted = tool.plant(text)
    for i in range(len(tool.PHASES)):
        assert f"clk[{i}] += n_ - tk" in planted
    assert planted.count("atomicAdd(&clocks[") == 4  # the phases and the whole run, twice
    assert "clock64" not in text
