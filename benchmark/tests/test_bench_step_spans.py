"""The readers of the training step's regions (``step_spans.py``): on a
hand-written profile with known gaps, the idle split, the launch count
and None when a region count is off; the tiny GPT-2 cell's own stretch
on the CPU; and, on the card, all five metrics read and the four idle
ones account for ``device_idle`` within 2 points."""

import types

import pytest

from benchmark import harness, step_spans

import bench_cells

SEED = 2 ** 31 + 13
IDLE = ["forward_idle.tokens", "backward_idle.tokens", "update_idle.tokens",
        "loop_idle.tokens"]
METRICS = IDLE + ["update_launches.tokens"]
# a step's regions, at offsets (us) from the step's start
STEP = [("step_dispatch", 10, 90), ("step.forward", 10, 30),
        ("step.backward", 30, 50), ("step.clip", 50, 55),
        ("step.update", 55, 70), ("step.guard", 70, 80),
        ("step.write", 80, 88)]
# the device's operations of a step, and the host's launch calls
KERNELS = [("gemm", 20, 40), ("adam", 60, 65)]
LAUNCHES = [("cuLaunchKernelEx", 52), ("cudaLaunchKernel", 56),
            ("cudaLaunchKernel_ptsz", 57), ("cudaLaunchKernelExC", 72),
            ("cudaLaunchKernel", 85), ("cudaLaunchKernel", 20),
            ("cudaMemcpyAsync", 60), ("cudaLaunchHostFunc", 61)]


class _Event:
    """A kineto event as ``harness.Profile`` reads one."""

    def __init__(self, name, start_us, end_us, kind="CPU", note=False):
        self._name, self._kind, self._note = name, kind, note
        self._s, self._e = start_us, end_us

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int((self._e - self._s) * 1000)

    def device_type(self):
        return "DeviceType." + self._kind

    def is_user_annotation(self):
        return self._note


def _profile(steps=2, drop=(), window_us=200.0):
    """Two steps 100 us apart in a 200 us stretch, with a copy between
    them and a kernel at the end; the device mirrors each step's
    ``step.update`` (an annotation, not an operation)."""
    evs = []
    for k in range(steps):
        t = 100.0 * k
        for name, s, e in STEP:
            if (k, name) not in drop:
                evs.append(_Event(name, t + s, t + e, note=True))
        evs.append(_Event("step.update", t + 55, t + 70, "CUDA", True))
        evs += [_Event(n, t + s, t + e, "CUDA") for n, s, e in KERNELS]
        evs += [_Event(n, t + s, t + s + 1) for n, s in LAUNCHES]
    evs += [_Event("copy", 95, 105, "CUDA"), _Event("mul", 195, 199, "CUDA")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(evs))))
    return harness.Profile(prof, window_us / 1e6)


def _run(profile, steps=2):
    return types.SimpleNamespace(profile=profile,
                                 record={"profile_steps": steps})


def _read(name, run):
    return harness.reader("layer_metrics", name, (harness.BENCH,)).read(run)


def test_the_idle_split_by_hand():
    run = _run(_profile())
    # busy: 20 + 5 a step, the copy's 10 and the last kernel's 4 = 64 us
    assert _read("device_idle.tokens", run) == pytest.approx(68.0)
    # forward [10, 30] against the gemm [20, 40]: 10 idle a step
    assert _read("forward_idle.tokens", run) == pytest.approx(10.0)
    assert _read("backward_idle.tokens", run) == pytest.approx(10.0)
    # clip to write, [50, 88]: 38 less adam's 5, a step
    assert _read("update_idle.tokens", run) == pytest.approx(33.0)
    # 136 idle in all, 55 a step inside step_dispatch
    assert _read("loop_idle.tokens", run) == pytest.approx(13.0)
    # the residue: [88, 90] a step, inside step_dispatch, in no region
    split = sum(_read(m, run) for m in IDLE)
    assert _read("device_idle.tokens", run) - split == pytest.approx(2.0)


def test_the_launch_count_by_hand():
    # clip 1, update 2 (one per-thread-stream form), guard 1, write 1;
    # the forward's launch, the copy and the host function do not count
    assert _read("update_launches.tokens", _run(_profile())) == 5.0
    for name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchKernelExC", "cudaLaunchKernelExC_v11060"):
        assert step_spans.LAUNCH.match(name), name
    for name in ("cudaLaunchHostFunc", "cudaMemcpyAsync",
                 "cudaLaunchCooperativeKernelX", "aten::cudaLaunchKernel"):
        assert not step_spans.LAUNCH.match(name), name


@pytest.mark.parametrize("case", ["steps", "no_update", "no_dispatch",
                                  "no_device", "no_profile"])
def test_none_when_the_stretch_does_not_hold_the_steps(case):
    profile, steps = _profile(), 2
    if case == "steps":
        steps = 3
    elif case == "no_update":
        profile = _profile(drop={(1, "step.update")})
    elif case == "no_dispatch":
        profile = _profile(drop={(0, "step_dispatch")})
    elif case == "no_device":
        profile.device_ops = []
    else:
        profile = None
    for name in METRICS:
        assert _read(name, _run(profile, steps)) is None, name


def test_the_tiny_cells_stretch_holds_each_region_a_step():
    run = bench_cells.prepare("tiny-gpt2.train", seed=SEED)
    run.trace = True
    harness.load_module(harness.find("drivers", run.cell["driver"],
                                     run.roots, ".py")).drive(run)
    steps = run.record["profile_steps"]
    s = step_spans.Stretch(run.profile, steps)
    for name in ("step_dispatch", "step.forward", "step.backward",
                 "step.clip", "step.update", "step.guard", "step.write"):
        assert len(s.regions.get(name, ())) == steps, name
    # no device on the CPU: every reader leaves its metric out
    for name in METRICS:
        assert _read(name, run) is None, name


@pytest.mark.card
def test_on_the_card_all_five_read_and_account_for_device_idle(card):
    out = bench_cells.run("tiny-gpt2.train", trace=True, seed=SEED,
                          device=card)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(METRICS) <= set(got), sorted(got)
    split = sum(got[m]["value"] for m in IDLE)
    assert abs(got["device_idle.tokens"]["value"] - split) <= 2.0, got
    assert got["update_launches.tokens"]["value"] > 0
