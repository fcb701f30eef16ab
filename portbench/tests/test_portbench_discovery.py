"""A configuration, a traffic mix, a driver and a per-layer metric are added
to a copy of the benchmark as new files and entries of ``BENCHMARK.json``;
the harness runs them with no file that was there edited."""
import hashlib
import json


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_found_by_name(tmp_path, make_tiny,
                                                run_child):
    root = make_tiny(tmp_path / "copy")
    before = _digests(root)
    bench = root / "portbench"
    (bench / "configs" / "grid5_300.json").write_text(json.dumps({
        "name": "grid5_300", "scenario": "grid", "rows": 5, "cols": 5,
        "block_length": 150.0, "capacity": 900.0, "freespeed": 11.1,
        "num_agents": 300, "zones": 3, "peak_start": 21600,
        "peak_spread": 120, "start_time": 21600, "simulated_s": 200}))
    (bench / "traffic" / "grid5_300.windowed.json").write_text(json.dumps({
        "driver": "episode_counted", "policy": "random", "zoned": False,
        "episode": "run_episode",
        "sim": {"timestep": 1, "record_road_optimality": False,
                "insert_window": 32, "sorted_population": True,
                "withdraw_depth": 2}}))
    # A new entry kind: the episode driver with its episodes counted.
    (bench / "drivers" / "episode_counted.py").write_text(
        "from portbench.drivers import episode\n"
        "from portbench.drivers.episode import Reference, replay_ticks\n"
        "CALLS = []\n\n\n"
        "class Program(episode.Program):\n"
        "    def run(self, state, ticks):\n"
        "        CALLS.append(ticks)\n"
        "        return super().run(state, ticks)\n")
    (bench / "metrics" / "tick.count.py").write_text(
        "import sys\n\n\n"
        "def read(run):\n"
        "    calls = sys.modules['portbench.drivers.episode_counted'].CALLS\n"
        "    return float(sum(calls[1:]))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "grid5_300", "source": "a test",
                            "file": "portbench/configs/grid5_300.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "grid5_300.windowed",
                              "config": "grid5_300",
                              "traffic": "grid5_300.windowed", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "tick.count", "unit": "ticks",
                              "better": "higher", "source": "host_clock",
                              "layer": "tick dispatch",
                              "moves": "agent_steps_per_s",
                              "workloads": ["grid5_300.windowed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {p: d for p, d in after.items() if p in before} == before

    out = run_child(root, "grid5_300.windowed", trace=True)
    assert out["harness"].startswith(str(root))
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["metrics"]["tick.count"]["value"] == res["attempted"]
    assert "refresh.ms" not in res["metrics"]     # not this cell's
    assert "choice.ms" not in res["metrics"]      # listed for other cells
    assert "tick.host_reads" in res["metrics"]    # every cell's


def test_end_to_end_run_reports_end_to_end_metrics(tiny_root, run_tiny):
    res = run_tiny(tiny_root, "grid128_1m.sp")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in spec["end_to_end"]
             if "grid128_1m.sp" in m.get("workloads", ["grid128_1m.sp"])}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checks"
