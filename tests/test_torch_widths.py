"""Every width a herro_tpu ``config.json`` can ask for, up to d_model 1024,
d_ff 4096 and any head dim that is a multiple of 16, in float32 and bf16.

* The plain versions the SIMT kernels stand beside (``ops/fused.py``,
  ``ops/attention.py``) against herro_tpu's Pallas kernels in interpret mode,
  float32, B 2 x L 512 (one block of their length tiling): at ``w768h96``'s
  widths (d 768, H 8 x D 96, d_ff 3072) and at d 1024 (H 8 x D 128, d_ff
  4096), K4, K1 and K8 (both rope routes), K2/K6/K7 (bands 512, 40, none), K9
  (the same bands) and K3; at head dims 48, 80 and 112, K1 (both routes) and
  K9. 1e-4, 2e-4 after the out projection, as ``tests/test_torch_float32.py``.
* ``bf16_kernel_name`` names the SIMT instance at every new width and the
  Hopper one at every width it named before.
* The wrappers refuse d 1056, d_ff 4128, head dims 24 and 136 (float32 and
  bf16), and the int8 ops d 768 and head dim 96, each in a ValueError that
  names the width and the range, before any launch (CPU tensors that say
  they are on the card; the launch recorded, not made).

The model at these widths is ``tests/test_torch_w768h96.py``'s. The kernels
themselves run on the card alone (``chip_smoke.py``'s ``widths`` phase).
"""

import contextlib

import numpy as np
import pytest
import torch

from herro_tpu_torch.ops import attention as tattn
from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

B, L, R, V = 2, 512, 31, 12
ATOL = 1e-4
# (d, H, D, d_ff) of the rows; the head dims 48, 80 and 112 at d 2 D
WIDTHS = {"w768h96": (768, 8, 96, 3072), "d1024": (1024, 8, 128, 4096)}
HEAD_DIMS = {48: (96, 2), 80: (160, 2), 112: (224, 2)}
BANDS = [512, 40, None]


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import attention as jattn
    from herro_tpu.ops import fused as jfused

    return dict(jnp=jnp, pltpu=pltpu, fused=jfused, attn=jattn)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(ref, *arrays):
    return tuple(map(ref["jnp"].asarray, arrays))


def _rng(seed):
    return np.random.default_rng(seed)


def _x_ln(rng, d, rows=(B, L)):
    x = rng.normal(size=(*rows, d)).astype(np.float32)
    return (x, (1 + rng.normal(0, 0.1, size=(d,))).astype(np.float32),
            rng.normal(0, 0.1, size=(d,)).astype(np.float32))


def _qkv_inputs(seed, d, H, D):
    rng = _rng(seed)
    x, s, b = _x_ln(rng, d)
    return (x, s, b, rng.normal(0, d ** -0.5, size=(d, 3 * H * D)).astype(np.float32),
            rng.normal(0, 0.1, size=(3 * H * D,)).astype(np.float32))


def _attn_inputs(seed, d, H, D, lengths=(L, L - 70)):
    rng = _rng(seed)
    q, k, v = (rng.normal(size=(len(lengths), H, L, D)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(len(lengths), L, d)).astype(np.float32)
    wo = rng.normal(0, (H * D) ** -0.5, size=(H, D, d)).astype(np.float32)
    bo = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    return q, k, v, x, wo, bo, np.asarray(lengths, dtype=np.int32)


def _valid_rows(got, want, lengths, atol, row_axis=1):
    for b, n in enumerate(lengths):
        sl = (b, slice(None, n)) if row_axis == 1 else (b, slice(None), slice(None, n))
        np.testing.assert_allclose(got[sl], want[sl], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# plain versions against herro_tpu's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", sorted(WIDTHS))
def test_entry_embed_plain_matches_pallas_interpret(tag, ref):
    d = WIDTHS[tag][0]
    rng = _rng(1)
    tok = rng.integers(0, 13, size=(B, R, L)).astype(np.uint8)  # 12: past the vocab
    tok[1, :, L - 70:] = 11
    quals = rng.uniform(-1, 1, size=(B, R, L)).astype(np.float32)
    w_embT = rng.normal(0, 0.2, size=(d, R * V)).astype(np.float32)
    w_qT = rng.normal(0, 0.2, size=(d, R)).astype(np.float32)
    cb = rng.normal(0, 0.1, size=(d,)).astype(np.float32)
    with ref["pltpu"].force_tpu_interpret_mode():
        want = ref["fused"]._entry_embed_pallas(*_j(ref, tok, quals, w_embT, w_qT, cb),
                                                ref["jnp"].float32, blk_l=L)
    got = fused.entry_embed(_t(tok), _t(quals), fused.col_proj_table(_t(w_embT), _t(w_qT)),
                            _t(cb), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


_QKV_REFERENCE: dict = {}


def _qkv_reference(ref, d, H, D):
    """The inputs and the reference's outputs by both routes at (d, H, D),
    made once for the two route cases."""
    if (d, H, D) not in _QKV_REFERENCE:
        args = _qkv_inputs(2, d, H, D)
        with ref["pltpu"].force_tpu_interpret_mode():
            _QKV_REFERENCE[(d, H, D)] = args, {
                r: [np.asarray(o) for o in ref["fused"]._ln_qkv_rope_pallas(
                    *_j(ref, *args), H, blk_t=L, rope_tbl=r == "tbl")]
                for r in ("tbl", "split")}
    return _QKV_REFERENCE[(d, H, D)]


QKV_CASES = [(tag, *WIDTHS[tag][:3]) for tag in sorted(WIDTHS)] + \
    [(f"D{D}", d, H, D) for D, (d, H) in sorted(HEAD_DIMS.items())]


@pytest.mark.parametrize("route", ["tbl", "split"])
@pytest.mark.parametrize("tag,d,H,D", QKV_CASES, ids=[c[0] for c in QKV_CASES])
def test_ln_qkv_rope_plain_matches_pallas_interpret(tag, d, H, D, route, ref):
    """Both rope routes of the reference against the one plain version (the
    card's K1 and K8 give its bits alike). The table route within 1e-4. The
    split route builds cos/sin inside the reference's kernel, and the
    reference's own two routes differ there (1.04e-4 at D 112, L 512): it is
    held within 1e-4 plus that gap, the gap itself below 2e-4."""
    args, routes = _qkv_reference(ref, d, H, D)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(routes["tbl"], routes["split"]))
    assert gap < 2 * ATOL
    got = fused.ln_qkv_rope(*map(_t, args), H)
    for g, w in zip(got, routes[route]):
        assert g.shape == (B, H, L, D)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL + (gap if route == "split" else 0),
                                   rtol=0)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("tag", sorted(WIDTHS))
def test_flash_outproj_plain_matches_pallas_interpret(tag, band, ref):
    """K2 (512), K6 (40) and K7 (none), the reference's own choice at each
    band."""
    d, H, D, _ = WIDTHS[tag]
    args = _attn_inputs(3, d, H, D)
    with ref["pltpu"].force_tpu_interpret_mode():
        want = ref["fused"]._flash_outproj_pallas(*_j(ref, *args), band)
    got = fused.flash_outproj(*map(_t, args), band)
    _valid_rows(got.numpy(), np.asarray(want), args[-1], 2 * ATOL)


K9_CASES = [(tag, *WIDTHS[tag][:3], band) for tag in sorted(WIDTHS) for band in BANDS] + \
    [(f"D{D}", d, H, D, None) for D, (d, H) in sorted(HEAD_DIMS.items())]


@pytest.mark.parametrize("tag,d,H,D,band", K9_CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in K9_CASES])
def test_flash_attention_plain_matches_pallas_interpret(tag, d, H, D, band, ref):
    """K9 (``attention()``'s kernel on the card), one example of length 0."""
    q, k, v, _, _, _, lengths = _attn_inputs(4, d, H, D, lengths=(L, L - 70, 0))
    with ref["pltpu"].force_tpu_interpret_mode():
        want = np.asarray(ref["attn"].flash_attention(*_j(ref, q, k, v, lengths), band))
    got = tattn._flash_attention_plain(*map(_t, (q, k, v, lengths)), band).numpy()
    _valid_rows(got, want, lengths, ATOL, row_axis=2)
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("tag", sorted(WIDTHS))
def test_ln_ffn_plain_matches_pallas_interpret(tag, ref):
    d, _, _, f = WIDTHS[tag]
    rng = _rng(5)
    x, s, b = _x_ln(rng, d, rows=(B * L,))
    args = (x, s, b, rng.normal(0, d ** -0.5, size=(d, f)).astype(np.float32),
            rng.normal(0, 0.1, size=(f,)).astype(np.float32),
            rng.normal(0, f ** -0.5, size=(f, d)).astype(np.float32),
            rng.normal(0, 0.1, size=(d,)).astype(np.float32))
    with ref["pltpu"].force_tpu_interpret_mode():
        want = ref["fused"]._ln_ffn_pallas(*_j(ref, *args), blk_t=L)
    got = fused.ln_ffn(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the choice of instance and the refusals
# ---------------------------------------------------------------------------


def test_bf16_kernel_name_takes_every_new_width_on_the_simt_instance(monkeypatch):
    """Every d_model a multiple of 32 up to 1024 and head dim a multiple of
    16 up to 128 that no Hopper instance takes goes to the SIMT one, every
    d_ff a multiple of 32 up to 4096 likewise; the Hopper instances keep
    every width they took."""
    monkeypatch.delenv("HERRO_TPU_ROPE", raising=False)
    hopper_qkv = {(d, 128) for d in fused.QKV_WIDTHS}
    for d in range(32, 1025, 32):
        assert fused.bf16_kernel_name("entry_embed", d, R=R) == (
            "entry_embed" if d in fused.EMBED_WIDTHS else "entry_embed_bf16")
        for D in range(16, 129, 16):
            if d == 32 and D not in kernels.POW2_HEAD_DIMS:
                continue  # the narrow K1/K8 (below)
            assert fused.bf16_kernel_name("ln_qkv_rope", d, D=D) == (
                "ln_qkv_rope" if (d, D) in hopper_qkv else "ln_qkv_rope_bf16")
        for f in range(32, 4097, 32):
            hopper = d in fused.FFN_WIDTHS and f % 128 == 0
            assert fused.bf16_kernel_name("ln_ffn", d, f) == (
                "ln_ffn" if hopper else "ln_ffn_bf16")
    for D in range(16, 129, 16):
        assert fused.bf16_kernel_name("flash_attention", D=D) == (
            "flash_attention" if D == 128 else "flash_bf16_attention")
        for H in (1, 2, 4, 8):
            if H * D > 1024 or H * D % 32:
                continue
            for band in (None, 40, 512):
                hopper = D == 128 and (H, H * D) in fused.ATTENTION_WIDTHS
                want = fused.flash_kernel_name(band) if hopper else (
                    "flash_bf16_full" if band is None else "flash_bf16")
                assert fused.bf16_kernel_name("flash_outproj", H * D, H=H, D=D,
                                              local_window=band) == want


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what ``on_card`` reads."""

    is_cuda = property(lambda self: True)


def _on_card(args):
    return tuple(a.clone().as_subclass(_OnCard) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.fixture
def launched(monkeypatch):
    """The launch (``cuda.call``) records the kernel's name instead of
    running it."""
    names = []
    monkeypatch.delenv("HERRO_TPU_PALLAS", raising=False)
    monkeypatch.setattr(kernels, "call", lambda name, *args: names.append(name))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fused, "_rope_tables_cached",
                        lambda L_, D, dev: fused.rope_tables(L_, D, "cpu"))
    return names


# (case, d, H, D, d_ff, the width named): one past each range
REFUSED = {"d1056": (1056, 2, 16, 64, "d_model 1056", "a multiple of 32 up to 1024"),
           "f4128": (64, 2, 16, 4128, "d_ff 4128", "a multiple of 32 up to 4096"),
           "D24": (96, 4, 24, 64, "head dim 24", "a multiple of 16 from 16 to 128"),
           "D136": (544, 4, 136, 64, "head dim 136", "a multiple of 16 from 16 to 128")}


def _op_case(op, d, H, D, f, dtype, seed=9, rows=64):
    rng = _rng(seed)
    r = lambda *shape, std=1.0: _t((rng.normal(size=shape) * std).astype(np.float32)).to(dtype)
    f32 = lambda *shape: _t((1 + 0.1 * rng.normal(size=shape)).astype(np.float32))
    x = r(1, rows, d)
    if op == "ln_qkv_rope":
        return fused.ln_qkv_rope, (x, f32(d), f32(d), r(d, 3 * H * D, std=d ** -0.5),
                                   r(3 * H * D), H)
    if op == "flash_outproj":
        q, k, v = (r(1, H, rows, D) for _ in range(3))
        return fused.flash_outproj, (q, k, v, x, r(H, D, d), r(d),
                                     torch.tensor([rows], dtype=torch.int32), 40)
    if op == "attention":
        q, k, v = (r(1, H, rows, D) for _ in range(3))
        return (lambda *a: tattn.attention(*a, 40)), (q, k, v,
                                                      torch.tensor([rows], dtype=torch.int32))
    if op == "entry_embed":
        tok = _t(rng.integers(0, 12, size=(1, R, rows)).astype(np.uint8))
        quals = _t(rng.uniform(-1, 1, size=(1, R, rows)).astype(np.float32))
        wc = fused.col_proj_table(r(d, R * V, std=0.2), r(d, R, std=0.2))
        return (lambda *a: fused.entry_embed(*a, dtype)), (tok, quals, wc, f32(d))
    return fused.ln_ffn, (x, f32(d), f32(d), r(d, f, std=d ** -0.5), r(f),
                          r(f, d, std=f ** -0.5), r(d))


REFUSALS = [(op, case) for op, cases in (
    ("entry_embed", ("d1056",)), ("ln_qkv_rope", ("d1056", "D24", "D136")),
    ("flash_outproj", ("d1056", "D24", "D136")), ("attention", ("D24", "D136")),
    ("ln_ffn", ("d1056", "f4128"))) for case in cases]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("op,case", REFUSALS)
def test_wrappers_refuse_one_past_each_range_before_any_launch(op, case, dtype, launched):
    d, H, D, f, width, takes = REFUSED[case]
    call, args = _op_case(op, d, H, D, f, dtype)
    with pytest.raises(ValueError, match=f"{width}: .*{takes}"):
        call(*_on_card(args))
    assert launched == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("op", ["entry_embed", "ln_qkv_rope", "flash_outproj", "attention",
                                "ln_ffn"])
def test_w768h96_widths_reach_the_simt_instances(op, dtype, launched):
    """At w768h96's widths every op launches its SIMT instance once (the
    Hopper ones in no dtype)."""
    call, args = _op_case(op, 768, 8, 96, 3072, dtype)
    call(*_on_card(args))
    sfx = "f32" if dtype == torch.float32 else "bf16"
    want = {"entry_embed": f"entry_embed_{sfx}", "ln_qkv_rope": f"ln_qkv_rope_{sfx}",
            "flash_outproj": f"flash_{sfx}", "attention": f"flash_{sfx}_attention",
            "ln_ffn": f"ln_ffn_{sfx}"}[op]
    assert launched == [want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("op,d,D,match", [
    ("ln_qkv_rope_q", 768, 96,
     r"d_model 768: the int8 SIMT kernels take a multiple of 32 up to 512"),
    ("ln_qkv_rope_q", 512, 96, r"head dim 96: the int8 SIMT kernels take \(16, 32, 64, 128\)"),
    ("ln_ffn_q", 768, 96, r"d_model 768: the int8 SIMT kernels take a multiple of 32 up to 512"),
])
def test_int8_refuses_the_new_widths_by_name_before_any_launch(op, d, D, match, dtype,
                                                               launched):
    """``--int8`` at w768h96's widths: its K10 and K11 refuse d 768 and head
    dim 96 on the card, naming int8 and its range (the next slice takes
    them), and launch nothing."""
    H, f = 8, 3072
    x = _on_card((torch.zeros(1, 64, d, dtype=dtype),))[0]
    s, b = torch.ones(d), torch.zeros(d)
    if op == "ln_qkv_rope_q":
        w_i8 = torch.zeros(d, 3 * H * D, dtype=torch.int8)
        args = (x, s, b, w_i8, torch.ones(3 * H * D), torch.zeros(3 * H * D), H)
    else:
        args = (x, s, b, torch.zeros(d, f, dtype=torch.int8), torch.ones(f), torch.zeros(f),
                torch.zeros(f, d, dtype=torch.int8), torch.ones(d), torch.zeros(d))
    with pytest.raises(ValueError, match=match):
        getattr(fused, op)(*args)
    assert launched == []
