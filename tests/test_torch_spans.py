"""The program's spans and counters (``utils/profiler.py``) on the CPU.

Off, a span is one flag check: no registry write, no ``record_function``.
On (a ``torch.profiler`` session records), spans nest per thread, carry
their request id, sit on the profiler's timeline, and are kept from any
thread; the enabled check is the profiler's process-wide Python flag,
since the C flag reads False on a thread the session did not start.  The
server's and the sampler step's spans and counters are checked on tiny
rooms and steps, with labels and state bit-identical to untraced runs.
``utils/trace_breakdown.py``'s busy time, kernel time by span and
labelled idle gaps are checked on made-up profiler events.
"""
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import make_synthetic_scene
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler as ds
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils import profiler
from pointcloud_segmentation_attention_tpu_torch.utils import trace_breakdown as tb

TINY = dict(sa_npoints=(32, 16, 8, 4), sa_radii=(0.2, 0.4, 0.8, 1.2), sa_nsample=8,
            sa_mlps=((16, 16),) * 4, fp_mlps=((16,), (16,), (16,), (16, 16)))
NPOINTS = 256


@pytest.fixture(autouse=True)
def fresh_registry():
    profiler.reset()
    yield
    profiler.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_path_records_nothing_and_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(profiler._autograd_profiler, "record_function", refuse)
    for _ in range(3):
        with profiler.span("serve.stage", request=7):
            with profiler.span("serve.pack"):
                profiler.count("serve.rooms")
    snap = profiler.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": [], "dropped": 0}


def test_nested_spans_on_one_thread():
    with _cpu_profile() as prof:
        with profiler.span("train.step", request=5):
            profiler.count("train.steps")
            with profiler.span("train.forward"):
                torch.ones(64).cumsum(0)
            with profiler.span("train.backward", request=9):
                pass
    names = {e.name for e in prof.events()}
    assert {"train.step", "train.forward", "train.backward"} <= names
    snap = profiler.snapshot()
    spans = snap["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {
        "train.step": 1, "train.forward": 1, "train.backward": 1}
    assert snap["counters"] == {"train.steps": 1}
    outer = spans["train.step"]
    children = spans["train.forward"]["total_s"] + spans["train.backward"]["total_s"]
    assert outer["total_s"] >= children
    assert outer["self_s"] == pytest.approx(outer["total_s"] - children, abs=1e-9)
    for name in ("train.forward", "train.backward"):
        assert spans[name]["self_s"] == spans[name]["total_s"]
    rec = {r["name"]: r for r in snap["records"]}
    assert rec["train.step"]["parent"] is None
    assert rec["train.forward"]["parent"] == rec["train.backward"]["parent"] == "train.step"
    assert (rec["train.step"]["request"], rec["train.forward"]["request"],
            rec["train.backward"]["request"]) == (5, 5, 9)
    assert rec["train.step"]["start_ns"] <= rec["train.forward"]["start_ns"] \
        <= rec["train.forward"]["end_ns"] <= rec["train.step"]["end_ns"]
    # Off again once the session ends.
    with profiler.span("train.step"):
        pass
    assert profiler.snapshot()["spans"]["train.step"]["count"] == 1


def test_a_background_thread_is_recorded_by_the_process_wide_flag():
    seen = {}

    def work(tag):
        seen[tag] = (torch._C._autograd._profiler_enabled(),
                     profiler._autograd_profiler._is_profiler_enabled)
        with profiler.span("serve.stage", request=tag):
            profiler.count("serve.rooms")

    for session, tag in ((profiler.profile_all_threads, 1), (_cpu_profile, 2)):
        with session() as prof:
            worker = threading.Thread(target=work, args=(tag,))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            with profiler.span("prefetch.wait"):
                pass
        on_timeline = [e for e in prof.events() if e.name == "serve.stage"]
        # The C flag is per thread and reads False there; the Python flag is on.
        assert seen[tag] == (False, True)
        if tag == 1:  # profile_all_threads puts the thread on the timeline
            assert len(on_timeline) == 1
            main = [e for e in prof.events() if e.name == "prefetch.wait"]
            assert on_timeline[0].thread != main[0].thread
    snap = profiler.snapshot()
    assert snap["counters"] == {"serve.rooms": 2}
    stage = [r for r in snap["records"] if r["name"] == "serve.stage"]
    assert [r["request"] for r in stage] == [1, 2]
    main_thread = [r for r in snap["records"] if r["name"] == "prefetch.wait"][0]["thread"]
    assert all(r["thread"] != main_thread and r["parent"] is None for r in stage)


def test_records_are_capped_and_aggregates_are_not(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_RECORDS", 3)
    with _cpu_profile():
        for _ in range(5):
            with profiler.span("nn.attention_pool"):
                pass
    snap = profiler.snapshot()
    assert snap["spans"]["nn.attention_pool"]["count"] == 5
    assert len(snap["records"]) == 3 and snap["dropped"] == 2


def _room(n, seed):
    rng = np.random.RandomState(seed)
    return {"scene_name": f"room{seed}",
            "points": (rng.rand(n, 3) * (3.0, 2.5, 2.5)).astype(np.float32),
            "colors": rng.randint(0, 256, (n, 3)).astype(np.uint8),
            "normals": rng.rand(n, 3).astype(np.float32)}


def test_server_spans_and_counters_a_room():
    model = models.get_model("sem_seg_features", device="cpu",
                             generator=torch.Generator().manual_seed(0), **TINY).eval()
    server = rs.ResidentSceneServer(model, NPOINTS, batch_size=4, layout="q16",
                                    pad_multiple=4096, device="cpu")
    rooms = [_room(n, s) for s, n in enumerate((900, 1500, 1200))]
    fetched = []
    fetch = server._fetch

    def recording_fetch(computed):
        fetched.append((int(computed[3]), computed[5]))
        return fetch(computed)

    server._fetch = recording_fetch
    plain = dict(server.predict_scenes(iter(rooms)))
    assert profiler.snapshot()["spans"] == {}
    fetched.clear()
    with _cpu_profile() as prof:
        traced = dict(server.predict_scenes(iter(rooms)))
    for r in rooms:
        np.testing.assert_array_equal(traced[r["scene_name"]], plain[r["scene_name"]])
    snap = profiler.snapshot()
    by_name = {}
    for rec in snap["records"]:
        by_name.setdefault(rec["name"], []).append(rec)
    for name in ("serve.stage", "serve.compute", "serve.label_wait", "serve.pack",
                 "serve.chunk_count", "serve.chunk_wait", "serve.upload"):
        assert sorted(r["request"] for r in by_name[name]) == [0, 1, 2], name
    for name in ("serve.pack", "serve.chunk_count", "serve.upload"):
        assert {r["parent"] for r in by_name[name]} == {"serve.stage"}
    assert {r["parent"] for r in by_name["serve.chunk_wait"]} == {"serve.chunk_count"}
    stage_threads = {r["thread"] for r in by_name["serve.stage"]}
    assert stage_threads.isdisjoint({r["thread"] for r in by_name["serve.compute"]})
    assert len(by_name["prefetch.wait"]) >= 3
    c = snap["counters"]
    assert c["serve.rooms"] == 3
    assert c["serve.vertices"] == sum(len(r["points"]) for r in rooms)
    assert c["serve.chunks"] == sum(n for n, _ in fetched)
    assert c["serve.slots"] == sum(cap for _, cap in fetched)
    assert [cap for _, cap in fetched] == [4 * -(-n // 4) for n, _ in fetched]
    assert 0 < c["serve.chunks"] <= c["serve.slots"] < c["serve.chunks"] + 4 * len(rooms)
    names = {e.name for e in prof.events()}
    assert {"serve.compute", "serve.label_wait", "prefetch.wait"} <= names


def test_sampler_step_spans_and_bit_identical_state():
    scenes = ds.ResidentScenes([make_synthetic_scene(3000, seed=s) for s in range(2)],
                               device="cpu", use_colors=False, use_normals=False)

    def fresh():
        model = models.get_model("sem_seg_attention", device="cpu",
                                 generator=torch.Generator().manual_seed(1), **TINY)
        return TrainState(model)

    step = ds.make_sampling_train_step(scenes, 128)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    plain, traced = fresh(), fresh()
    _, m_plain = step(plain, ids, 3)
    assert profiler.snapshot()["spans"] == {}
    with _cpu_profile() as prof:
        _, m_traced = step(traced, ids, 3)
    assert torch.equal(m_plain["loss"], m_traced["loss"])
    for (k, a), (_, b) in zip(plain.model.state_dict().items(),
                              traced.model.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(plain.model.parameters(), traced.model.parameters()):
        sp, sq = plain.optimizer.state[p], traced.optimizer.state[q]
        assert all(torch.equal(sp[k], sq[k]) for k in sp)
    snap = profiler.snapshot()
    assert snap["counters"] == {"train.steps": 1}
    spans = snap["spans"]
    assert spans["train.step"]["count"] == 1 and spans["nn.attention_pool"]["count"] == 4
    rec = {}
    for r in snap["records"]:
        rec.setdefault(r["name"], []).append(r)
    outer = rec["train.step"][0]
    assert outer["request"] == 0
    for name in ("train.sample", "train.forward", "train.backward", "train.optimizer"):
        (r,) = rec[name]
        assert r["parent"] == "train.step" and r["request"] == 0, name
        assert outer["start_ns"] <= r["start_ns"] <= r["end_ns"] <= outer["end_ns"]
    assert {r["parent"] for r in rec["nn.attention_pool"]} == {"train.forward"}
    phases = sum(spans[n]["total_s"] for n in ("train.sample", "train.forward",
                                               "train.backward", "train.optimizer"))
    assert spans["train.step"]["self_s"] == pytest.approx(
        spans["train.step"]["total_s"] - phases, abs=1e-9)
    names = {e.name for e in prof.events()}
    assert {"train.step", "train.sample", "train.forward", "train.backward",
            "train.optimizer", "nn.attention_pool"} <= names


# -- utils/trace_breakdown.py on made-up profiler events --------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _evt(name, start, end, device=CUDA, thread=1, parent=None, annotation=False, id=0):
    e = types.SimpleNamespace(name=name, device_type=device, thread=thread, cpu_parent=parent,
                              is_user_annotation=annotation, id=id)
    e.time_range = types.SimpleNamespace(start=start, end=end,
                                         elapsed_us=lambda: end - start)
    return e


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


def test_busy_time_is_the_union_of_kernel_intervals():
    events = [_evt("ampere_sgemm_128x64", 0, 100), _evt("elementwise_kernel", 50, 150),
              _evt("Memcpy HtoD (Pinned -> Device)", 140, 400),
              _evt("bench.step", 0, 1000, annotation=True), _evt("fps_regs_kernel", 300, 350)]
    res = tb.device_breakdown(_prof(events), 1e-3)
    assert res["busy_ms"] == pytest.approx(0.2)              # [0, 150) and [300, 350)
    assert res["device_ms"] == pytest.approx((100 + 100 + 260 + 50) / 1e3)
    assert res["device_busy_share"] == pytest.approx(0.2)
    assert res["groups"]["memcpy/memset"]["ms"] == pytest.approx(0.26)


def test_kernel_time_by_span_and_idle_gaps_by_span():
    step = _evt("train.step", 0, 1000, CPU)
    fwd = _evt("train.forward", 10, 400, CPU, parent=step)
    mm = _evt("aten::mm", 20, 30, CPU, parent=fwd, id=7)        # an ATen op's launch
    add = _evt("aten::add", 500, 510, CPU, parent=step, id=7)    # op ids are not CUDA's
    stage = _evt("serve.stage", 0, 1300, CPU, thread=2)
    pack = _evt("serve.pack", 600, 900, CPU, thread=2, parent=stage)
    launches = [
        _evt("cudaLaunchKernel", 22, 24, CPU, parent=mm, id=101),
        _evt("cudaLaunchKernelExC", 50, 52, CPU, parent=fwd, id=102),   # ctypes, in the span
        _evt("cudaLaunchKernel", 502, 504, CPU, parent=add, id=103),
        _evt("cudaMemsetAsync", 505, 506, CPU, parent=add, id=104),
        _evt("cudaLaunchKernel", 1200, 1201, CPU, id=105),              # no span open
        _evt("cudaLaunchKernel", 100, 101, CPU, id=106),                # unparented, in the forward
        _evt("cudaLaunchKernel", 700, 701, CPU, thread=3, id=107),      # autograd's thread
    ]
    device = [_evt("sgemm", 100, 200, id=101), _evt("fps_regs_kernel", 200, 250, id=102),
              _evt("elementwise", 520, 550, id=103), _evt("Memset (Device)", 551, 552, id=104),
              _evt("mul", 1220, 1227, id=105), _evt("relu", 250, 270, id=106),
              _evt("sgemm_bwd", 710, 750, id=107), _evt("mystery", 760, 770, id=999),
              _evt("train.forward", 100, 270, annotation=True, id=7)]
    prof = _prof([step, fwd, mm, add, stage, pack] + launches + device)
    assert tb.kernel_ms_by_span(prof) == pytest.approx(
        {"train.forward": 0.17, "train.step": 0.03, "(no program span)": 0.017,
         "serve.pack+train.step": 0.04})
    gaps = tb.idle_gaps(prof, top=3)
    # Midpoints 995, 395 and 630: on thread 1 the step, the forward, the step;
    # on thread 2 the stage, the stage, the pack inside it.
    assert [g[0] for g in gaps] == ["serve.stage+train.step", "serve.stage+train.forward",
                                    "serve.pack+train.step"]
    assert [g[1] for g in gaps] == pytest.approx([0.45, 0.25, 0.16])
