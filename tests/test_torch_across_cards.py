"""The across-cards entry (``tools/across_cards_torch.py``) and what it reads.

* Its layout table on CPU replicas (``--device cpu``): every row of
  ``CLI_ROWS`` through the ``inference`` CLI at TINY_CONFIG's widths with 4
  heads, and the ``train`` CLI row, each with the JSON fields it prints and
  its bars (data parallelism writes the single replica's records, tensor
  parallelism agrees on >= ``chip_smoke.TP_MIN_AGREE`` of the supported
  columns with equal decisions, the train row moves every parameter).
* On the card it refuses, with a non-zero exit that names the shortfall, a
  host with fewer cards than the layouts need (``torch.cuda.device_count``
  monkeypatched): it never runs a layout on one card named again.
* ``ops/cuda.py``'s launch counter by card, and ``chip_smoke.want_by_card``.
* ``chip_smoke.py`` hands its layout phases (``parallel``, ``multihost``,
  ``train_parallel``) ``cuda:0`` repeated, so that the one-card smoke run
  is what it was; the across-cards entry hands them distinct cards.
"""

import collections
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "across_cards_torch.py")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from herro_tpu_torch.ops import cuda as kernels  # noqa: E402

ROW_FIELDS = {"run", "layout", "flags", "mesh", "int8", "tp", "records_equal",
              "class_agreement", "supported_columns", "decisions_equal", "batches", "wall_s",
              "windows_per_s", "launches_by_card", "want_launches_by_card", "ok"}


def _tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("across_cards_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_rows():
    res = subprocess.run([sys.executable, TOOL, "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


def test_cpu_layout_table_holds_every_row(cpu_rows):
    tool = _tool()
    rows = {r["layout"]: r for r in cpu_rows if r.get("run") == "inference"}
    assert list(rows) == [t[0] for t in tool.CLI_ROWS]
    for tag, _, cards, int8, tp in tool.CLI_ROWS:
        r = rows[tag]
        assert set(r) == ROW_FIELDS, tag
        assert r["ok"] and r["decisions_equal"] and r["supported_columns"] > 0, r
        assert r["tp"] == tp and r["int8"] == int8 and r["flags"][-2:] == ["--device", "cpu"]
        assert len(r["mesh"]) * len(r["mesh"][0]) == cards and len(r["mesh"][0]) == tp
        assert r["launches_by_card"] == {}  # no kernel on the CPU
        if tp == 1:
            assert r["records_equal"]
        else:
            assert r["class_agreement"] >= chip_smoke.TP_MIN_AGREE


def test_cpu_train_row_and_last_line(cpu_rows):
    train = [r for r in cpu_rows if r.get("run") == "train"]
    assert len(train) == 1 and train[0]["ok"] and train[0]["unmoved"] == []
    assert train[0]["config_equal"] and train[0]["parameters"] > 0
    assert "--devices" in train[0]["args"]
    assert cpu_rows[-1] == {"ok": True, "failed": [], "device": {"platform": "cpu"}}


@pytest.mark.parametrize("have", [0, 1, 2, 3])
def test_refuses_fewer_cards_than_a_layout_needs(have, monkeypatch, capsys):
    tool = _tool()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: have > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
    assert tool.main([]) == 2
    err = capsys.readouterr().err
    if have:
        assert f"need {tool.NEED_CARDS} distinct cards, this host has {have}" in err
        assert f"({tool.NEED_CARDS - have} short)" in err
    else:
        assert "no CUDA device" in err
    assert capsys.readouterr().out == ""  # no row, no result


def test_every_layout_fits_the_cards_it_needs():
    tool = _tool()
    assert max(c for *_, c, _, _ in tool.CLI_ROWS) == tool.NEED_CARDS
    assert max(n * t for _, n, t in tool.STEP_LAYOUTS) == tool.NEED_CARDS
    assert max(n * t for _, n, t, _ in chip_smoke.PARALLEL_LAYOUTS) == tool.NEED_CARDS
    assert chip_smoke.TRAIN_INT8_LAYOUTS == tuple(
        t for t in chip_smoke.TRAIN_LAYOUTS if t[0] in ("single_int8", "tp2_int8"))


def test_launch_counts_by_card():
    counts = kernels.LaunchCounts(["a", "b"])
    counts.bump("a", 0)
    counts.bump("a", 2)
    counts.bump("b", 2)
    assert counts.snapshot() == {"a": 2, "b": 1}
    assert counts.by_device() == {0: {"a": 1}, 2: {"a": 1, "b": 1}}
    counts.reset()
    assert counts.snapshot() == {"a": 0, "b": 0} and counts.by_device() == {}


def test_call_counts_the_launch_under_the_current_card(monkeypatch):
    counts = kernels.LaunchCounts(list(kernels.KERNELS))
    monkeypatch.setattr(kernels, "launch_counts", counts)
    results = {"ln_ffn": 0, "entry_embed": 7}
    monkeypatch.setattr(kernels._libs, "fn", lambda name: (lambda *args: results[name]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    kernels.call("ln_ffn", 1, 2)
    kernels.call("ln_ffn")
    with pytest.raises(RuntimeError, match="entry_embed failed to launch: error 7"):
        kernels.call("entry_embed")  # a refused launch counts nowhere
    assert counts.by_device() == {3: {"ln_ffn": 2}}
    assert counts.snapshot()["ln_ffn"] == 2 and counts.snapshot()["entry_embed"] == 0


def test_want_by_card_on_one_card_and_across_cards():
    one, four = chip_smoke.one_card(torch), [torch.device("cuda", i) for i in range(4)]
    assert one == [torch.device("cuda", 0)] * chip_smoke.SMOKE_MESH_DEVICES
    # 2 replicas x 2 shards, 3 layers, 5 batches
    across = chip_smoke.want_by_card(four, 2, False, 3, 5)
    assert across == {0: {"entry_embed": 5, "ln_qkv_rope": 15, "flash_outproj": 15,
                          "ln_ffn": 15, "count_decisions": 5},
                      1: {"entry_embed": 5, "ln_qkv_rope": 15, "flash_outproj": 15,
                          "ln_ffn": 15},
                      2: {"entry_embed": 5, "ln_qkv_rope": 15, "flash_outproj": 15,
                          "ln_ffn": 15, "count_decisions": 5},
                      3: {"entry_embed": 5, "ln_qkv_rope": 15, "flash_outproj": 15,
                          "ln_ffn": 15}}
    # the same layout on cuda:0 named four times: every launch on card 0
    assert chip_smoke.want_by_card(one, 2, False, 3, 5) == {0: {
        "entry_embed": 20, "ln_qkv_rope": 60, "flash_outproj": 60, "ln_ffn": 60,
        "count_decisions": 10}}
    int8 = chip_smoke.want_by_card(four[:2], 2, True, 3, 1)
    assert set(int8[1]) == {"entry_embed", "ln_qkv_rope_q", "flash_outproj",
                            "ln_ffn_q_rowmax", "ln_ffn_q_rowscale"}
    assert chip_smoke.block_kernels(True, 1) == ("ln_qkv_rope_q", "flash_outproj", "ln_ffn_q")


def test_smoke_hands_the_layout_phases_cuda0_repeated(monkeypatch):
    """``chip_smoke.main`` with every phase recorded (and the card faked)
    up to ``train_parallel``: the three layout phases get ``cuda:0``
    repeated, as many times as the widest layout's shards."""
    calls = {}

    class Stop(Exception):
        pass

    def recorder(name):
        def record(*args, **kwargs):
            calls[name] = args
            if name == "phase_train_parallel":
                raise Stop
            return collections.defaultdict(lambda: None)
        return record

    for name in [n for n in dir(chip_smoke) if n.startswith("phase_")]:
        monkeypatch.setattr(chip_smoke, name, recorder(name))
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "a card, 700.00 W")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a card")
    monkeypatch.setattr(kernels, "build_all", lambda: 0.0)
    with pytest.raises(Stop):
        chip_smoke.main()
    zero = torch.device("cuda", 0)
    assert calls["phase_parallel"][3] == [zero] * 4
    assert calls["phase_multihost"][2] == [zero] * 2
    assert calls["phase_train_parallel"][2] == [zero] * 4
