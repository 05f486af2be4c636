"""chip_smoke.py: refuses to run without a GPU, and its phases' logic
holds at tiny sizes on the CPU (the card runs them at full size)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_cpu_host_exits_nonzero_without_result(args):
    r = _run(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_outside_repo_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_forced_route_restores_env(monkeypatch):
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "123")
    with chip_smoke.forced_route(chip_smoke.DEVICE):
        assert os.environ["SEQUILA_HOST_THRESHOLD"] == "0"
    assert os.environ["SEQUILA_HOST_THRESHOLD"] == "123"
    with chip_smoke.forced_route(None):
        assert "SEQUILA_HOST_THRESHOLD" not in os.environ
    assert os.environ["SEQUILA_HOST_THRESHOLD"] == "123"


def test_phase_fixture():
    chip_smoke.phase_fixture()


def test_phase_genome_small():
    chip_smoke.phase_genome(20_000, 60_000)


def test_phase_parity_small():
    chip_smoke.phase_parity(3_000, 4_000, 20_000, chain=(2_000, 5_000),
                            chain_pairs=None)


def test_phase_primitive_small():
    chip_smoke.phase_primitive(3_000, 9_000)


def test_phase_four_cards_small():
    """The four-card phase on four of the suite's virtual CPU devices."""
    chip_smoke.phase_four_cards(20_000, 60_000, 5_000)
