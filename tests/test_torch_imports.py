"""plangen_tpu_torch imports torch and never jax (the card machine has none)."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_never_imports_jax():
    import plangen_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        plangen_tpu_torch.__path__, prefix="plangen_tpu_torch.")]
    for name in ("ops.decode_attention", "ops.int4_matmul", "ops.quant", "ops.flash_attention",
                 "models.siglip", "data.collate", "data.loader", "data.registry", "data.toy",
                 "train.checkpoint", "train.loss", "train.metrics", "train.optim",
                 "train.step", "train.trainer"):
        assert "plangen_tpu_torch." + name in names
    code = (
        "import importlib, sys\n"
        f"for name in {['plangen_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_never_imports_jax_and_needs_a_card():
    """Without a CUDA device chip_smoke.py exits non-zero, prints no result,
    and by then has imported no jax."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code != 0, e.code\n"
        "assert 'jax' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_last_line_counts_the_card_it_used():
    """The run drives cuda:0 only: the last line says one card, whatever
    `torch.cuda.device_count()` reports on the machine."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    class FakeCuda:
        count = 4

        @staticmethod
        def get_device_name(index):
            assert index == 0
            return "NVIDIA H100 80GB HBM3"

        @classmethod
        def device_count(cls):
            return cls.count

    class FakeTorch:
        cuda = FakeCuda

    for count in (1, 4, 8):
        FakeCuda.count = count
        line = chip_smoke.device_line(FakeTorch)
        assert line == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chip_smoke_flash_bound_counts_the_allowed_pairs(causal):
    """`flash_work` counts what the masks allow, a row with no allowed key
    counting all S keys, against a count by hand; `roofline_ms` is the larger
    of the two times at the data sheet's rates."""
    smoke = _chip_smoke()
    B, S, H, D = 4, 70, 3, 64
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[1, :5] = 0
    mask[2, :66] = 0
    mask[3] = 0
    pairs = 0
    for b in range(B):
        for i in range(S):
            n = sum(int(mask[b, j] > 0 and (not causal or j <= i)) for j in range(S))
            pairs += H * (n if n else S)
    work = smoke.flash_work(torch, mask, H, D, causal)
    tensor, small = B * S * H * D * 2, B * S * 4 + B * H * S * 4
    assert work == {"fwd": (4 * D * pairs, 4 * tensor + small),
                    "bwd": (10 * D * pairs, 8 * tensor + small)}
    keep = smoke.rows_with_key(mask, causal)
    assert keep.tolist() == [[any(mask[b, j] > 0 and (not causal or j <= i) for j in range(S))
                              for i in range(S)] for b in range(B)]
    assert smoke.roofline_ms(989e12, 1.0) == pytest.approx(1e3)
    assert smoke.roofline_ms(1.0, 3.35e12) == pytest.approx(1e3)
    assert smoke.bound_by(2 * 989e12, 3.35e12) == "operations"
    assert smoke.bound_by(989e12, 2 * 3.35e12) == "bytes"
