"""The program's ``dmlc_tpu.*`` ranges in a synthetic Chrome trace: the
window's summary reads what it read without them, the program's
reduction splits the idle time over them and counts the CUDA calls inside
their wall, and the readers of the program's counters give None where the parent's
program keeps none."""

import json

import pytest

from portbench import harness, program_trace, registry, trace

from conftest import ROOT

BENCH = registry.benchmark(ROOT)
PID, MAIN, OTHER = 1, 10, 11


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"name": name, "cat": cat, "ph": "X", "pid": PID, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _trace(tmp_path, program: bool):
    """A 100 us window with two steps, idle 10-20 (inside the first step's
    backward), 50-60 (in the input wait) and 90-100 (outside any range)."""
    ev = [_x(trace.WINDOW, "user_annotation", 0, 100),
          _x("portbench.step", "user_annotation", 0, 40),
          _x("portbench.next", "user_annotation", 40, 20),
          _x("portbench.step", "user_annotation", 60, 30),
          _x("Optimizer.step#Adam.step", "cpu_op", 30, 8),
          _x("_GatherRowsBackward", "cpu_op", 12, 10),
          # launches: one blocks 15-25 inside the first step's backward
          _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 15, 10, correlation=2),
          _x("cudaLaunchKernel", "cuda_runtime", 31, 1, correlation=3),
          _x("cudaLaunchKernel", "cuda_runtime", 61, 2, correlation=4),
          _x("cudaStreamSynchronize", "cuda_runtime", 0, 100, tid=OTHER),
          _x("fwd", "kernel", 0, 10, correlation=1),
          _x("scatter", "kernel", 20, 10, correlation=2),
          _x("adam", "kernel", 30, 20, correlation=3),
          _x("h2d", "gpu_memcpy", 60, 5),
          _x("fwd", "kernel", 65, 25, correlation=4)]
    if program:
        ev += [_x("dmlc_tpu.step", "user_annotation", 1, 38),
               _x("dmlc_tpu.step.forward", "user_annotation", 1, 9),
               _x("dmlc_tpu.step.backward", "user_annotation", 10, 19),
               _x("dmlc_tpu.step.optimizer", "user_annotation", 29, 10),
               _x("dmlc_tpu.input_wait", "user_annotation", 45, 15),
               _x("dmlc_tpu.dispatch", "user_annotation", 60, 1),
               _x("dmlc_tpu.step", "user_annotation", 61, 29),
               # a range on another thread is not the window's
               _x("dmlc_tpu.convert", "user_annotation", 0, 100, tid=OTHER)]
    path = tmp_path / f"trace{int(program)}.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_the_program_ranges_leave_the_summary_as_it_was(tmp_path):
    bare = trace.summarize(_trace(tmp_path, False))
    ranged = trace.summarize(_trace(tmp_path, True))
    for key in ("window_s", "busy_s", "step_s", "copy_s", "idle_gaps", "device_ops"):
        assert ranged[key] == bare[key], key
    for fragment in ("Optimizer.step#", "_GatherRowsBackward"):
        assert trace.seconds_under(ranged, fragment) == trace.seconds_under(bare, fragment)
        assert trace.seconds_under(ranged, fragment) > 0
    # the program's names only join the tuples
    assert any("dmlc_tpu.step.optimizer" in names for names in ranged["by_ranges"])


def test_idle_splits_by_the_innermost_range_and_sums_to_the_idle_time(tmp_path):
    path = _trace(tmp_path, True)
    summary = trace.summarize(path)
    program = program_trace.reduce(path)
    idle = program["idle_by_range"]
    assert sum(idle.values()) == pytest.approx(summary["window_s"] - summary["busy_s"])
    assert idle == pytest.approx({"dmlc_tpu.step.backward": 10e-6,
                                  "dmlc_tpu.input_wait": 10e-6, "none": 10e-6})
    bare = program_trace.reduce(_trace(tmp_path, False))
    assert bare["ranges"] == {} and bare["idle_by_range"] == pytest.approx({"none": 30e-6})


def test_runtime_is_taken_out_of_the_step_wall(tmp_path):
    path = _trace(tmp_path, True)
    ranges = program_trace.reduce(path)["ranges"]
    assert set(ranges) == {"dmlc_tpu.step", "dmlc_tpu.step.forward", "dmlc_tpu.step.backward",
                           "dmlc_tpu.step.optimizer", "dmlc_tpu.input_wait",
                           "dmlc_tpu.dispatch"}
    step = ranges["dmlc_tpu.step"]
    assert step["count"] == 2
    assert step["wall_s"] == pytest.approx(67e-6)
    # the launches at 2, 15-25 (the blocking one), 31 and 61-63; the other
    # thread's synchronize counts where it overlaps the step
    assert step["runtime_s"] == pytest.approx(67e-6)
    assert ranges["dmlc_tpu.step.backward"]["runtime_s"] == pytest.approx(19e-6)
    idle = program_trace.reduce(path)["idle_by_range"]
    summary = trace.summarize(path)
    in_step = sum(v for k, v in idle.items() if k.startswith("dmlc_tpu.step"))
    assert in_step == pytest.approx(10e-6) and idle["dmlc_tpu.input_wait"] == pytest.approx(10e-6)
    assert in_step + idle["dmlc_tpu.input_wait"] <= summary["window_s"] - summary["busy_s"]
    # the step's host time: its wall less the CUDA calls inside it
    assert step["wall_s"] - step["runtime_s"] == pytest.approx(0.0, abs=1e-12)


def test_a_blocking_launch_on_the_window_thread_alone(tmp_path):
    """Without the other thread's call, the step's host time is its wall
    less the four launches (1 + 10 + 1 + 2 us)."""
    path = _trace(tmp_path, True)
    doc = json.loads(open(path).read())
    doc["traceEvents"] = [e for e in doc["traceEvents"] if e["name"] != "cudaStreamSynchronize"]
    open(path, "w").write(json.dumps(doc))
    step = program_trace.reduce(path)["ranges"]["dmlc_tpu.step"]
    assert step["runtime_s"] == pytest.approx(14e-6)
    assert step["wall_s"] - step["runtime_s"] == pytest.approx(53e-6)


def test_a_trace_without_the_window_is_refused(tmp_path):
    path = tmp_path / "nowindow.json"
    path.write_text(json.dumps({"traceEvents": [_x("dmlc_tpu.step", "user_annotation", 0, 5)]}))
    with pytest.raises(ValueError, match=trace.WINDOW):
        program_trace.reduce(str(path))


def _run(stats0, stats1, window_s=2.0):
    return harness.Run(config={}, cell={}, window_s=window_s, stats0=stats0, stats1=stats1)


@pytest.mark.parametrize("name", ["convert_offcpu_share", "parse_busy_share"])
def test_the_counter_readers_read_nothing_on_a_program_without_the_counters(name):
    # the parent's stats(): no convert CPU seconds, no native parse busy time
    old = {"convert_seconds": 1.0, "convert_workers": 2,
           "parse_parallel": {"parse_workers": 4, "parse_busy_seconds": None}}
    assert registry.metric_reader(name).read(_run(old, old)) is None
    assert registry.metric_reader(name).read(_run({}, {})) is None
    assert registry.metric_reader(name).read(_run(old, old, window_s=0.0)) is None


def test_the_counter_readers_read_the_window():
    s0 = {"convert_seconds": 1.0, "convert_cpu_seconds": 0.75, "convert_workers": 2,
          "parse_parallel": {"parse_workers": 4, "parse_busy_seconds": 3.0}}
    s1 = {"convert_seconds": 3.0, "convert_cpu_seconds": 2.25, "convert_workers": 2,
          "parse_parallel": {"parse_workers": 4, "parse_busy_seconds": 7.0}}
    run = _run(s0, s1)
    assert registry.metric_reader("convert_offcpu_share").read(run) == pytest.approx(12.5)
    assert registry.metric_reader("parse_busy_share").read(run) == pytest.approx(50.0)


def test_the_new_metrics_are_listed_for_both_cells():
    # every cell that parses its text in the window: the cold route's
    cells = [w["name"] for w in BENCH["workloads"]
             if registry.workload(w["name"]).get("route", "cold") == "cold"]
    assert len(cells) >= 2
    for name in ("convert_offcpu_share", "parse_busy_share"):
        # under its own name, or split as <name>.<kind> in cells that report other metrics
        entries = [m for m in BENCH["per_layer"] if m["name"].split(".", 1)[0] == name]
        assert sorted(c for m in entries for c in m["workloads"]) == sorted(cells)
        assert {m["source"] for m in entries} == {"program_counter"}
