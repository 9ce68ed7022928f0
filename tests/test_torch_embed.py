"""K4's SIMT instances (``csrc/entry_embed_simt.cuh``: ``entry_embed_f32``,
``entry_embed_bf16``) and their plain version.

* The plain version (``fused.entry_embed`` on CPU tensors) against
  herro_tpu's Pallas kernel ``_entry_embed_pallas`` in interpret mode, in
  float32 (within 1e-5) and bf16 (within 2^-6 of the largest output, 4 bf16
  ulps, as ``chip_smoke.compare`` holds bf16), at the shapes whose tails the
  kernel handles apart: R 1 and 63, d 32, 96 and 512, L = 37 (not a multiple
  of 16, so the kernel stages its tokens and quals by its own loads; one
  ragged tile), tokens past the vocab and zero quals mixed in.
* The kernel's launch plan (``fused.embed_simt_plan``, the mirror of
  ``entry_embed_simt.cuh:launch``): its constants are the source's, and every
  (d, R, dtype) the wrapper takes fits one block's 227 KB of shared memory,
  ring included, as does the most the launch asks for.
* ``tools/embed_clocks_torch.py``'s anchors.
* ``gpu``: each instance against its plain version on the card, one launch,
  B=1 at L 1, 17, 1000 (staged by loads), 1008 (bulk copies, a ragged last
  tile) and 9216, R 1, 31 and 63, d 32, 64, 480 and 512: bit for bit at
  tiny's bf16 widths (d 32, R 31), within 1e-4 in float32, at compare's bf16
  bars elsewhere. These skip inside the test without a card and import no
  JAX.
"""

import os
import re

import numpy as np
import pytest
import torch

from herro_tpu_torch.constants import VOCAB_SIZE as V
from herro_tpu_torch.ops import cuda as kernels
from herro_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "herro_tpu_torch", "csrc")
BF = torch.bfloat16
ATOL = 1e-5


def _pileup(seed, R, d, B=2, L=37, dtype=torch.float32, dev="cpu"):
    """Tokens (a tenth past the vocab: 12, 13 or 255; the padding token
    elsewhere), quals (a fifth exactly 0), the weights as herro_tpu takes
    them (w_embT [d, R V], w_qT [d, R], float32 or bf16) and the bias."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, size=(B, R, L)).astype(np.uint8)
    past = rng.random(size=tok.shape) < 0.1
    tok[past] = rng.choice(np.array([V, V + 1, 255], np.uint8), size=int(past.sum()))
    quals = rng.uniform(-1, 1, size=(B, R, L)).astype(np.float32)
    quals[rng.random(size=quals.shape) < 0.2] = 0.0
    std = (R * (V + 1)) ** -0.5
    w_embT = torch.from_numpy(rng.normal(0, std, size=(d, R * V))).to(dev, dtype)
    w_qT = torch.from_numpy(rng.normal(0, std, size=(d, R))).to(dev, dtype)
    cb = torch.from_numpy(rng.normal(0, 0.25, size=d).astype(np.float32)).to(dev)
    return torch.from_numpy(tok).to(dev), torch.from_numpy(quals).to(dev), w_embT, w_qT, cb


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from herro_tpu.ops import fused as jfused

    return jnp, pltpu, jfused


def _jax(jnp, t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == BF \
        else jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 96, 512])
@pytest.mark.parametrize("R", [1, 63])
def test_entry_embed_plain_matches_pallas_interpret(R, d, dtype, ref):
    jnp, pltpu, jfused = ref
    dt = getattr(torch, dtype)
    tok, quals, w_embT, w_qT, cb = _pileup(10 * R + d, R, d, dtype=dt)
    with pltpu.force_tpu_interpret_mode():
        want = jfused._entry_embed_pallas(
            *(_jax(jnp, a) for a in (tok, quals, w_embT, w_qT, cb)), getattr(jnp, dtype))
    got = fused.entry_embed(tok, quals, fused.col_proj_table(w_embT, w_qT), cb, dt)
    assert got.dtype == dt and got.shape == (2, 37, d)
    want = np.asarray(want, dtype=np.float32)
    atol = ATOL if dt == torch.float32 else np.abs(want).max() * 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _constants(path):
    with open(path) as fh:
        text = fh.read()
    return text, {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_embed_plan_mirrors_the_kernel_source():
    """``fused.embed_simt_plan``'s constants and formula are
    ``entry_embed_simt.cuh``'s, and its limit is ``common.cuh``'s."""
    text, c = _constants(os.path.join(CSRC, "entry_embed_simt.cuh"))
    _, common = _constants(os.path.join(CSRC, "common.cuh"))
    assert (c["kSlice"], c["kTile"], c["kRing"], c["kHead"]) == (
        fused.EMBED_SIMT_SLICE, fused.EMBED_SIMT_TILE, fused.EMBED_SIMT_RING,
        fused.EMBED_SIMT_HEAD)
    assert c["kMaxRows"] == fused.F32_MAX_ROWS and c["kSlot"] == fused.COL_SLOT
    assert common["kMaxSmem"] == fused.SMEM_LIMIT
    assert "return R * kTile * 5;" in text  # a slot: tokens (1 B) and quals (4 B)
    assert ("return kHead + kRing * slot_bytes(R) + (R * (V + 1) + 1) * kSlice * "
            "(int)sizeof(float);") in text
    assert "set_smem(kernel, smem_bytes(kMaxRows, kSlot - 1))" in text


def test_embed_plan_fits_shared_memory_at_every_width():
    """Every d (a multiple of 32 up to 512) and R (1-63) the wrapper takes,
    in float32 and bf16 alike (the table is float32 in either), and
    the largest launch the attribute is set for (R 63, V 15), fit 227 KB;
    the slices cover d."""
    for d in range(32, fused.F32_MAX_D_MODEL + 1, 32):
        for R in range(1, fused.F32_MAX_ROWS + 1):
            plan = fused.embed_simt_plan(d, R)
            assert plan["slices"] * fused.EMBED_SIMT_SLICE == d
            assert plan["smem"] <= fused.SMEM_LIMIT, (d, R, plan)
    most = fused.embed_simt_plan(512, fused.F32_MAX_ROWS, V=fused.COL_SLOT - 1)
    assert most["smem"] <= fused.SMEM_LIMIT


def test_clock_tool_plants_its_laps_in_a_copy_of_the_sources():
    """``tools/embed_clocks_torch.py`` finds each anchor of the tiled kernel
    as often as it expects, laps every phase and flushes its counters."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "embed_clocks_torch", os.path.join(ROOT, "tools", "embed_clocks_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(CSRC, "entry_embed_simt.cuh")) as fh:
        text = fh.read()
    planted, kind = tool.plant(text)
    assert kind == "tiled"
    for i, phase in enumerate(tool.PHASES):
        assert (f"clk[{i}] += n_ - tk" in planted) == (phase in tool.KIND_PHASES[kind])
    assert planted.count("atomicAdd(&clocks[") == 3  # the phases, the whole run, the warps
    assert "clock64" not in text


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


def _launched(fn):
    before = kernels.launch_counts.snapshot()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts.snapshot()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 480, 512])
@pytest.mark.parametrize("R", [1, 31, 63])
@pytest.mark.parametrize("L", [1, 17, 1000, 1008, 9216])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_embed_simt_matches_plain_on_card(dtype, L, R, d):
    from chip_smoke import compare

    dev = _card()
    dt = getattr(torch, dtype)
    tok, quals, w_embT, w_qT, cb = _pileup(L + R + d, R, d, B=1, L=L, dtype=dt, dev=dev)
    args = (tok, quals, fused.col_proj_table(w_embT, w_qT), cb, dt)
    name = "entry_embed_f32" if dt == torch.float32 else "entry_embed_bf16"
    got, launched = _launched(lambda: fused._entry_embed_cuda(*args, kernel=name))
    assert launched == {name: 1}
    want = fused._entry_embed_plain(*args)
    assert got.dtype == dt and got.shape == (1, L, d)
    if dt == torch.float32:
        err, tol, _, _ = compare(torch, got, want, atol=1e-4)
    else:
        err, tol, _, _ = compare(torch, got, want, exact=d == 32 and R == 31)
    assert err <= tol, (err, tol)
