"""The port's featurization against the frozen featgen goldens, byte for byte.

``tests/golden/featgen_v3.npz`` and ``featgen_sys_v1.npz`` hold herro_tpu's
featurization of two fixed-seed simulations (``tests/make_golden.py``); the
port's ``features/`` and ``native/`` are copies of herro_tpu's, and these
tests keep them so: ``tests/torch_data/featgen_windows.py`` builds the same
windows through ``herro_tpu_torch`` alone, and every array must have the
golden's dtype, shape and bytes (the counterparts of ``tests/test_golden.py``,
which holds herro_tpu's featgen against the same files).
"""

import importlib.util
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_data")


def _windows_module():
    spec = importlib.util.spec_from_file_location(
        "featgen_windows", os.path.join(DATA, "featgen_windows.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def built():
    return _windows_module()


@pytest.fixture(scope="module")
def golden(built):
    return np.load(os.path.join(built.GOLDEN_DIR, "featgen_v3.npz"))


@pytest.fixture(scope="module")
def current(built):
    return built.build_windows()


def _assert_bytes_identical(gold, cur, what):
    assert sorted(gold.files) == sorted(cur.keys()), what
    for name in gold.files:
        a, b = gold[name], cur[name]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {name}"
        assert a.tobytes() == b.tobytes(), f"{what} drift in {name}"


def test_same_window_set(golden, current):
    assert len(current) > 0
    assert sorted(golden.files) == sorted(current.keys())


def test_bytes_identical(golden, current):
    _assert_bytes_identical(golden, current, "the port's featurization")


def test_systematic_profile_bytes_identical(built):
    _assert_bytes_identical(np.load(os.path.join(built.GOLDEN_DIR, "featgen_sys_v1.npz")),
                            built.build_windows_sys(), "the port's systematic featurization")
