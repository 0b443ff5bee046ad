"""The parts of chip_smoke.py's contract a CPU can check: it refuses to run
without a GPU, its result line, a failing phase, and phase selection."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


class _Dev:
    platform = "gpu"
    device_kind = "Fake GPU"


def _fake_card(monkeypatch, n_devices=1):
    seen = {}

    def require_gpu(n_cards):
        seen["n_cards"] = n_cards
        return [_Dev()] * n_devices

    monkeypatch.setattr(chip_smoke, "require_gpu", require_gpu)
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "Fake GPU, 1.00 W")
    monkeypatch.setattr(chip_smoke, "OUT", "")
    monkeypatch.setattr(chip_smoke.os, "makedirs", lambda *a, **k: None)
    return seen


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def case_no_gpu(tmp_path, monkeypatch, capsys):
    r = _run_script(REPO)
    assert r.returncode != 0
    assert "not a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def case_alone_in_directory(tmp_path, monkeypatch, capsys):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def case_result_line(tmp_path, monkeypatch, capsys):
    line = chip_smoke.result_line([_Dev(), _Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Fake GPU", "count": 2}}
    assert "\n" not in line


def case_passing_phases(tmp_path, monkeypatch, capsys):
    _fake_card(monkeypatch)
    ran = []
    monkeypatch.setattr(chip_smoke, "select_phases",
                        lambda four: [("a", lambda s: ran.append("a")),
                                      ("b", lambda s: ran.append("b"))])
    assert chip_smoke.main([]) == 0
    assert ran == ["a", "b"]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == "Fake GPU, 1.00 W"
    assert json.loads(out[-1])["ok"] is True


def case_failing_phase(tmp_path, monkeypatch, capsys):
    _fake_card(monkeypatch)
    ran = []

    def boom(smoke):
        smoke.check("some error", 1.0, 1e-6, "test")

    monkeypatch.setattr(chip_smoke, "select_phases",
                        lambda four: [("boom", boom),
                                      ("after", lambda s: ran.append(1))])
    with pytest.raises(RuntimeError, match="exceeds"):
        chip_smoke.main([])
    assert not ran
    out = capsys.readouterr().out
    assert "FAIL" in out and '"ok"' not in out


def case_four_cards_selects_only_its_phases(tmp_path, monkeypatch, capsys):
    names4 = {n for n, _ in chip_smoke.select_phases(True)}
    names1 = {n for n, _ in chip_smoke.select_phases(False)}
    assert names4 == {"sharded_fast_day", "ensemble_members"}
    assert not names4 & names1
    seen = _fake_card(monkeypatch, n_devices=4)
    ran = []
    monkeypatch.setattr(chip_smoke, "FOUR_CARDS",
                        (("four", lambda s: ran.append("four")),))
    monkeypatch.setattr(chip_smoke, "ONE_CARD",
                        (("one", lambda s: ran.append("one")),))
    assert chip_smoke.main(["--four-cards"]) == 0
    assert ran == ["four"] and seen["n_cards"] == 4
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


def case_one_card_by_default(tmp_path, monkeypatch, capsys):
    seen = _fake_card(monkeypatch)
    ran = []
    monkeypatch.setattr(chip_smoke, "FOUR_CARDS",
                        (("four", lambda s: ran.append("four")),))
    monkeypatch.setattr(chip_smoke, "ONE_CARD",
                        (("one", lambda s: ran.append("one")),))
    assert chip_smoke.main([]) == 0
    assert ran == ["one"] and seen["n_cards"] == 1


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chip_smoke_contract(name, tmp_path, monkeypatch, capsys):
    CASES[name](tmp_path, monkeypatch, capsys)
