"""ddp_tpu_torch's fault drills, supervisor and watchdog, on the CPU.

- ``runtime/chaos.parse_chaos`` / ``format_chaos`` equal the JAX
  package's on a seeded corpus of plans (every event kind: rank, fleet,
  reload and stage events), and both reject the same malformed specs.
- ``runtime/launch.classify_exit`` equals JAX's on every exit class.
- An event fires once across engines through the per-rank ledger.
- ``ckpt_corrupt:latest`` makes the next run quarantine the latest epoch,
  write a ``fallback`` record and resume from the epoch before.
- The step watchdog turns a stall into exit 124 in a subprocess, which
  the supervisor classifies as a watchdog timeout.
- ``runtime/consensus`` agrees through one all-reduce (a world of one
  needs no process group).
- The trainer's chaos guards (a bad spec, step events under
  ``--fast_epoch``).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ddp_tpu.runtime import chaos as jchaos
from ddp_tpu.runtime.launch import classify_exit as jclassify
from ddp_tpu_torch.runtime import chaos, consensus, dist, launch
from ddp_tpu_torch.train.trainer import main as train_main

REPO = Path(__file__).resolve().parent.parent
CNN = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "128",
       "--batch_size", "16", "--log_interval", "4", "--eval_every", "0"]


def _plan(rng):
    """One random plan as a spec string, over every event kind."""
    tokens = []
    for _ in range(int(rng.integers(1, 6))):
        kind = int(rng.integers(0, 10))
        at = int(rng.integers(0, 10_000))
        unit = "step" if rng.integers(0, 2) else "epoch"
        secs = f"{round(float(rng.integers(1, 400)) / 10, 1):g}s"
        r = int(rng.integers(0, 8))
        tokens.append([
            f"kill:rank{r}@{unit}{at}", f"sigterm:rank{r}@{unit}{at}",
            f"shrink:rank{r}@{unit}{at}", f"grow:+1@{unit}{at}",
            f"stall:input@{unit}{at}:{secs}", "ckpt_corrupt:latest",
            f"kill:replica{r}@request{at}", f"stall:replica{r}@request{at}:{secs}",
            f"kill:stage{r}@step{at}" if kind == 8 else "ckpt_corrupt:reload",
            f"stall:stage{r}@step{at}:{secs}" if rng.integers(0, 2)
            else f"kill:replica{r}@reload",
        ][kind])
    return ",".join(tokens)


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


def test_chaos_grammar_equals_jax_on_a_corpus():
    rng = np.random.default_rng(0)
    for _ in range(300):
        spec = _plan(rng)
        got, want = chaos.parse_chaos(spec), jchaos.parse_chaos(spec)
        assert _fields(got) == _fields(want), spec
        assert chaos.format_chaos(got) == jchaos.format_chaos(want) == spec
        assert chaos.parse_chaos(chaos.format_chaos(got)) == got
        for sub in ("fleet_events", "reload_events", "stage_events"):
            assert _fields(getattr(chaos, sub)(spec)) == _fields(
                getattr(jchaos, sub)(spec)), (sub, spec)
    assert chaos.parse_chaos(None) == () == chaos.parse_chaos("  ")


@pytest.mark.parametrize("bad", [
    "kill:rank1", "kill@step3", "stall:input@step3", "stall:input@step3:0s",
    "explode:rank0@step1", "ckpt_corrupt:oldest", "shrink:rank1",
    "shrink@step3", "grow:+2@epoch1", "grow:rank1@step3",
    "kill:stage1@epoch2", "stall:stage1@step3", "kill:stage1@step3:2s",
    "sigterm:stage1@step3", "sigterm:replica1@reload",
    "stall:replica1@reload:2s", "kill:replica@reload", "kill:rank1@reload",
    "ckpt_corrupt:reload2", "stall:replica1@request3",
    "kill:replica1@request3:2s",
])
def test_both_packages_reject_the_same_malformed_specs(bad):
    with pytest.raises(ValueError) as want:
        jchaos.parse_chaos(bad)
    with pytest.raises(ValueError) as got:
        chaos.parse_chaos(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("code", [None, -signal.SIGKILL, -signal.SIGTERM, 1,
                                  124, 86, 87])
def test_classify_exit_equals_jax(code):
    assert launch.classify_exit(code) == jclassify(code)
    assert (launch.WATCHDOG_EXIT_CODE, launch.SHRINK_EXIT_CODE,
            launch.GROW_EXIT_CODE) == (124, 86, 87)


def test_events_fire_once_across_engines(tmp_path, monkeypatch):
    """The ledger is what lets a restart loop replay the steps without
    replaying the fault; a rank never fires another rank's event, and a
    trainer engine never fires fleet, reload or stage events."""
    ledger = str(tmp_path / "ledger.json")
    sleeps = []
    monkeypatch.setattr(chaos.time, "sleep", sleeps.append)
    ev = chaos.parse_chaos("stall:input@step3:0.5s")
    eng = chaos.ChaosEngine(ev, rank=0, ledger_path=ledger)
    eng.on_step(2)
    assert sleeps == []
    eng.on_step(3)
    eng.on_step(3)
    assert sleeps == [0.5]
    chaos.ChaosEngine(ev, rank=0, ledger_path=ledger).on_step(3)
    assert sleeps == [0.5]
    assert json.loads(Path(ledger).read_text()) == {
        "fired": ["stall:input@step3:0.5s"]}
    # Would SIGKILL this process if it were mis-targeted.
    chaos.ChaosEngine(chaos.parse_chaos(
        "kill:rank1@step3,kill:replica0@request3,kill:stage0@step3,"
        "kill:replica0@reload,ckpt_corrupt:reload"), rank=0,
        ledger_path=str(tmp_path / "l0.json")).on_step(3)


def test_corrupt_latest_quarantines_and_writes_a_fallback_record(tmp_path):
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    train_main(CNN + ["--epochs", "2", "--checkpoint_dir", ck])
    t = train_main(CNN + ["--epochs", "3", "--checkpoint_dir", ck,
                          "--chaos", "ckpt_corrupt:latest",
                          "--metrics_file", metrics])
    assert [h["epoch"] for h in t.history] == [1, 2]  # epoch 1 retrained
    names = sorted(os.listdir(ck))
    assert "quarantine.epoch-1" in names and "epoch_1.manifest.json" in names
    assert (Path(ck) / "quarantine.epoch-1" / "ddp_tpu.manifest.json"
            ).is_file()  # the manifest moved with its epoch
    records = [json.loads(l) for l in open(metrics)]
    fallback = [r for r in records if r["kind"] == "fallback"]
    assert len(fallback) == 1
    assert fallback[0]["epoch"] == 1 and fallback[0]["resumed_epoch"] == 0
    assert "size" in fallback[0]["problems"][0]
    assert fallback[0]["quarantined_path"].endswith("quarantine.epoch-1")
    assert [r["kind"] for r in records][:2] == ["fallback", "run_start"]
    start = records[1]
    assert (start["restarts"], start["start_epoch"], start["world_size"]) \
        == (1, 1, 1)  # the second start on this directory
    assert json.loads((Path(ck) / "chaos_ledger.rank0.json").read_text()) == {
        "fired": ["ckpt_corrupt:latest"]}


def test_corrupt_latest_checkpoint_hits_the_state_file(tmp_path):
    (tmp_path / "epoch_0").mkdir()
    (tmp_path / "epoch_3").mkdir()
    (tmp_path / "epoch_3" / "state.pt").write_bytes(b"x" * 1000)
    (tmp_path / "epoch_3" / "metrics.json").write_bytes(b"{}")
    victim = chaos.corrupt_latest_checkpoint(str(tmp_path), seed=0)
    assert victim.endswith(os.path.join("epoch_3", "state.pt"))
    assert 0 < os.path.getsize(victim) < 1000
    assert chaos.corrupt_latest_checkpoint(str(tmp_path / "none")) is None


def test_watchdog_exits_124_in_a_subprocess():
    code = (
        "import time\n"
        "from ddp_tpu_torch.utils.watchdog import StepWatchdog\n"
        "wd = StepWatchdog(0.3)\n"
        "wd.start()\n"
        "for _ in range(3):\n"
        "    time.sleep(0.1); wd.beat()\n"
        "time.sleep(30)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 124, res.stderr[-2000:]
    assert "no training progress" in res.stderr
    assert "Thread" in res.stderr or "File" in res.stderr  # the stack dump
    assert "watchdog timeout" in launch.classify_exit(res.returncode)


def test_watchdog_disabled_and_forensics():
    from ddp_tpu_torch.utils import watchdog

    fired = []
    wd = watchdog.StepWatchdog(0.0, on_timeout=fired.append)
    wd.start()
    wd.beat()
    wd.stop()
    assert wd._thread is None and fired == []
    seen = []
    fn = watchdog.register_forensics(lambda: seen.append(1))
    watchdog.register_forensics(lambda: 1 / 0)  # isolated
    watchdog.run_forensics()
    watchdog.unregister_forensics(fn)
    watchdog._FORENSICS.clear()
    watchdog.unregister_forensics(fn)  # a missing one is ignored
    assert seen == [1]


def test_consensus_single_rank_and_one_reduce():
    # A world of one: identity, no process group needed.
    assert consensus.agree_any(True, num_processes=1) is True
    assert consensus.agree_any([True, False], num_processes=1) == [True, False]
    assert consensus.agree_all([True, False], num_processes=1) == [True, False]
    # Forced through the collective in a one-rank gloo group.
    dist.setup(device="cpu")
    try:
        assert consensus.agree_any([True, False, True], num_processes=2) == [
            True, False, True]
        assert consensus.agree_all([True, True], num_processes=2) == [True,
                                                                      True]
        assert consensus.agree_any(False, num_processes=2) is False
    finally:
        dist.cleanup()


def test_trainer_chaos_guards(tmp_path):
    kw = CNN + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck")]
    with pytest.raises(ValueError, match="bad chaos event"):
        train_main(kw + ["--chaos", "kill:rank1"])
    with pytest.raises(ValueError, match="fast_epoch"):
        train_main(kw + ["--chaos", "kill:rank0@step3", "--fast_epoch"])
    with pytest.raises(ValueError, match="fast_epoch"):
        train_main(kw + ["--watchdog_timeout", "5", "--fast_epoch"])
    # Epoch triggers compose with --fast_epoch; the event never fires.
    t = train_main(kw + ["--chaos", "sigterm:rank0@epoch5", "--fast_epoch"])
    assert t.summary["epochs_run"] == 1


def test_spawn_validates_min_world():
    def worker(rank, world):  # pragma: no cover — never launched
        pass

    with pytest.raises(ValueError, match="min_world"):
        launch.spawn(worker, 2, min_world=0)
    with pytest.raises(ValueError, match="min_world"):
        launch.spawn(worker, 2, min_world=3)
