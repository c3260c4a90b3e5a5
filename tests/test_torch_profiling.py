"""The port's tracing (``jrc_tpu_torch.utils.profiling``) on the CPU: host
spans (nesting, parent ids, self time, the bounded per-call ring, the
timeline and its clock), counters, idle gaps on a synthetic device trace,
the stage ring's plain version, and the entry points that feed them: a
``BlockStreamer`` (its calls, slots and frames against ``StreamStats`` and
the frames placed, every host span timed), a ``CapturedFunction`` on CPU
tensors and the JRC dwell's stages. The card's side (event-timed calls,
stage medians against them, the merged clock) is in
``tests/test_torch_cuda.py``.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu_torch import capture  # noqa: E402
from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType  # noqa: E402
from jrc_tpu_torch.io.stream import BlockStreamer  # noqa: E402
from jrc_tpu_torch.ops.encoder import FrameSpec  # noqa: E402
from jrc_tpu_torch.utils import graph, profiling  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _spin(ns: int) -> None:
    t = time.perf_counter_ns()
    while time.perf_counter_ns() - t < ns:
        pass


def test_spans_nest_with_parent_ids_and_self_time():
    with profiling.recording():
        with profiling.span("outer", 7) as outer:
            _spin(200_000)
            with profiling.span("inner") as inner:
                _spin(300_000)
            with profiling.span("inner"):
                _spin(100_000)
    s = profiling.spans()
    assert s["inner"]["n"] == 2 and s["outer"]["n"] == 1
    assert s["inner"]["self_ns"] == s["inner"]["total_ns"] >= 400_000
    assert s["outer"]["self_ns"] == s["outer"]["total_ns"] - s["inner"]["total_ns"]
    assert s["outer"]["self_ns"] >= 200_000
    rec = profiling.recorded()
    assert [r["name"] for r in rec] == ["inner", "inner", "outer"]  # in the order they closed
    assert rec[0]["parent"] == rec[1]["parent"] == outer.sid == rec[2]["id"]
    assert rec[0]["id"] == inner.sid and rec[2]["parent"] == 0
    assert all(r["call"] == 7 for r in rec)  # an inner span takes its parent's call
    assert rec[2]["start"] <= rec[0]["start"] < rec[0]["end"] <= rec[1]["start"] <= rec[2]["end"]


def test_recording_off_stores_no_span_and_counters_still_add():
    with profiling.recording():
        with profiling.span("kept"):
            pass
    for k in range(2):
        with profiling.span("a", k):
            _spin(1000)
    assert [r["name"] for r in profiling.recorded()] == ["kept"]  # the last recording alone
    a = profiling.spans()["a"]
    assert a["n"] == 2 and a["total_ns"] >= 2000 and a["self_ns"] == a["total_ns"]
    assert len(profiling.per_call_ms("a")) == 2
    with profiling.recording():
        pass
    assert profiling.recorded() == []


def test_the_per_call_ring_is_bounded():
    n = profiling.KEEP + 100
    for k in range(n):
        with profiling.span("a", k):
            pass
        with profiling.span("b", k):
            pass
        with profiling.span("b", k):
            pass
    assert profiling.spans()["a"]["n"] == n
    per_call = profiling.per_call_ms("a", "b")
    # b's ring holds two samples a call: the calls both rings cover are b's last KEEP / 2
    assert len(per_call) == profiling.KEEP // 2
    assert len(profiling.per_call_ms("a")) == profiling.KEEP
    assert profiling.per_call_ms("a", "missing") == profiling.per_call_ms("a")
    assert profiling.per_call_ms("missing") == [] and profiling.median([]) is None


def test_the_timeline_stands_on_the_realtime_clock():
    before = time.time_ns()
    with profiling.recording():
        with profiling.span("x"):
            _spin(1_000_000)
    after = time.time_ns()
    (r,) = profiling.recorded()
    # the anchor's two reads are a few microseconds apart
    assert before - 1_000_000 <= r["start"] < r["end"] <= after + 1_000_000
    assert r["end"] - r["start"] >= 1_000_000


def _synthetic_trace(base: int) -> dict:
    """Three kernels at 0-10, 20-30 and 25-50 µs and a copy at 80-90, on a
    profiler trace's clock (ts µs after baseTimeNanoseconds)."""
    ev = [("k1", 0, 10), ("k2", 20, 10), ("k3", 25, 25)]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in ev]
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 10})
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 12, "dur": 100})
    return {"traceEvents": events, "baseTimeNanoseconds": base}


def test_idle_gaps_name_the_innermost_open_span():
    base = 1_700_000_000_000_000_000
    spans = [{"name": "outer", "start": base + 5_000, "end": base + 60_000},
             {"name": "inner", "start": base + 8_000, "end": base + 15_000}]
    gaps = profiling.idle_gaps(_synthetic_trace(base), spans)
    # 10-20 µs: inner opened at 8 and still open at 10; 50-80 µs: nothing open at 50 but outer
    assert gaps == [(base + 50_000, 30_000, "outer"), (base + 10_000, 10_000, "inner")]
    assert profiling.idle_gaps(_synthetic_trace(base), [])[0][2] == profiling.OUTSIDE


def test_export_merges_the_spans_into_a_profiler_trace(tmp_path):
    with profiling.recording():
        with profiling.span("x", 3):
            pass
    (r,) = profiling.recorded()
    base = r["start"] - 4_000
    out = profiling.export(tmp_path / "t.json", _synthetic_trace(base))
    trace = json.loads(out.read_text())
    (x,) = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    assert x["name"] == "x" and x["ts"] == pytest.approx(4.0) and x["args"]["call"] == 3
    assert len(trace["traceEvents"]) == 6 and trace["baseTimeNanoseconds"] == base
    alone = json.loads(profiling.export(tmp_path / "s.json").read_text())
    assert [e["name"] for e in alone["traceEvents"]] == ["x"] and alone["traceEvents"][0]["ts"] == 0


def test_the_stage_ring_plain_version_keeps_rows_in_call_and_stage_order():
    x = torch.zeros(4)
    stages = profiling.STAGES["dwell"]
    profiling.stamp("dwell", "tx", x)  # before any call: nothing written
    for _ in range(3):
        for s in stages:
            profiling.stamp("dwell", s, x)
    profiling.stamp("dwell", "start", x)  # a fourth call under way: not complete
    profiling.stamp("dwell", "tx", x)
    rows = profiling.stage_rows("dwell")
    assert [r[0] for r in rows] == [1, 2, 3]
    for r in rows:
        assert len(r) == 1 + len(stages) and r[1:] == sorted(r[1:])
    assert rows[0][-1] <= rows[1][1] <= rows[2][1]
    ms = profiling.stage_ms("dwell")
    assert list(ms) == list(stages[1:]) and all(v >= 0 for v in ms.values())
    assert profiling.stage_ms("rx") == {}


def test_the_stage_ring_wraps_after_rows_calls(monkeypatch):
    monkeypatch.setattr(profiling, "ROWS", 4)
    x = torch.zeros(1)
    for _ in range(6):
        for s in profiling.STAGES["dwell"]:
            profiling.stamp("dwell", s, x)
    assert [r[0] for r in profiling.stage_rows("dwell")] == [3, 4, 5, 6]


def test_captured_function_on_cpu_tensors_counts_calls_and_captures_nothing():
    f = graph.jit(lambda v: v * 2, name="double")
    x = torch.arange(4.0)
    for _ in range(3):
        assert torch.equal(f(x), x * 2)
    assert (f.replays, f.captures) == (0, 0)
    assert profiling.spans()["graph.replay"]["n"] == 3
    assert len(profiling.per_call_ms("graph.replay")) == 3  # one call index each
    assert profiling.device_ms("double") == []


def test_block_streamer_counts_calls_slots_and_frames_on_the_cpu():
    cfg = OFDMConfig()
    frame, _, _ = capture.load_bench_frame()
    block_len, max_frames = 1 << 13, 4
    rng = np.random.default_rng(0)
    n = 6 * block_len
    cap = (rng.normal(0, 1e-4, (n, 2)) @ [1, 1j]).astype(np.complex64)
    pos, placed = 600, 0
    while pos + len(frame) < n - 4 * block_len:  # every frame well before the flush
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + 2500
        placed += 1
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    s = BlockStreamer(cfg, spec, block_len=block_len, max_frames=max_frames, device="cpu")
    results = []
    for i in range(0, n, 3000):
        s.push(cap[i : i + 3000])
        results += list(s.process_available())
    results += list(s.flush())
    st = s.stats
    assert placed >= 2 and st.frames == st.crc_ok == placed
    assert st.calls == len(results) == st.blocks and st.slots_decoded == st.calls * max_frames
    assert profiling.tracked("rx") is st  # read once the streamer is gone
    assert len(st.ring_fill) == st.calls and min(st.ring_fill) >= s.span + s.halo
    spans = profiling.spans()
    for name in ("stream.push", "stream.dispatch", "stream.pop", "stream.readback",
                 "graph.replay"):
        assert spans[name]["n"] > 0 and spans[name]["total_ns"] > 0, name
    assert spans["graph.replay"]["n"] == st.calls
    # the dispatch holds the pop and the call: its self time is the rest
    assert spans["stream.dispatch"]["self_ns"] < spans["stream.dispatch"]["total_ns"]
    assert len(profiling.per_call_ms("stream.push", "stream.pop")) >= st.calls - 1
    # every call stamped its seven stages, in order
    rows = profiling.stage_rows("rx")
    assert len(rows) == st.calls and list(profiling.stage_ms("rx")) == list(
        profiling.STAGES["rx"][1:])


def test_the_dwell_stamps_its_stages_once_a_call_on_the_cpu():
    from jrc_tpu_torch.models import comm_link, jrc_trx
    from jrc_tpu_torch.ops import channel

    cfg = OFDMConfig()
    trx = jrc_trx.JRCTrx(cfg, interp_factor_range=1, interp_factor_angle=1, device="cpu")
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.NDP)
    payload = torch.zeros(spec.payload_bytes, dtype=torch.uint8)
    targets = channel.Targets((12.0,), (0.0,), (25.0,), (10.0,))
    state = trx.init_state()
    for _ in range(2):
        state = trx(state, spec, payload, targets, comm_noise_var=1e-4,
                    draws=comm_link.Draws()).state
    rows = profiling.stage_rows("dwell")
    assert [r[0] for r in rows] == [1, 2]
    assert list(profiling.stage_ms("dwell")) == ["tx", "channel", "radar", "comm_rx"]


def test_summary_line_reads_the_counters():
    for k in range(3):
        with profiling.span("stream.push", k):
            pass
        with profiling.span("stream.readback", k):
            pass
    from jrc_tpu_torch.io.stream import StreamStats

    line = profiling.summary("rx", calls=3, seconds=1.0, busy=("stream.push",),
                             blocked=("stream.readback",),
                             stats=StreamStats(frames=16, slots_decoded=64),
                             captured=graph.jit(lambda v: v))
    assert line.startswith("counters rx: calls=3 slots_used=16/64 (25.00%) replays=0 "
                           "captures=0 host_busy_ms=")
    assert "device_idle=n/a" in line and line.endswith("stage_ms n/a")


def test_the_apps_print_their_counters_and_write_the_trace(tmp_path, capsys):
    """``comm_rx`` and ``jrc_trx`` on the CPU: one counters line each on
    standard error, their stdout unchanged by it, and ``--trace-out``'s
    merged trace holding the program's spans (no device trace on a CPU)."""
    from jrc_tpu_torch.apps import comm_rx, jrc_trx

    assert comm_rx.main(["--cpu", "--demo", "--block-len", "8192",
                         "--trace-out", str(tmp_path / "rx")]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[-1].startswith("blocks=4 frames=")
    (line,) = [ln for ln in err.splitlines() if ln.startswith("counters rx: calls=4 ")]
    assert "slots_used=" in line and "stage_ms detect=" in line and "finish=" in line
    assert "replays=0 captures=0" in line  # the captured call runs as it is on a CPU
    names = {e["name"] for e in json.loads((tmp_path / "rx" / "trace.json").read_text())[
        "traceEvents"]}
    assert {"stream.push", "stream.dispatch", "stream.pop", "stream.readback",
            "graph.replay"} <= names
    assert jrc_trx.main(["--cpu", "--frames", "2", "--heatmap", "",
                         "--radar-log", str(tmp_path / "r.csv"),
                         "--comm-log", str(tmp_path / "c.csv"),
                         "--trace-out", str(tmp_path / "dwell")]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[-1].startswith("bursts=1 tx_only=1")
    (line,) = [ln for ln in err.splitlines() if ln.startswith("counters dwell: calls=2 ")]
    assert "stage_ms tx=" in line and "comm_rx=" in line
    names = {e["name"] for e in json.loads((tmp_path / "dwell" / "trace.json").read_text())[
        "traceEvents"]}
    assert names == {"jrc.frame", "jrc.readback"}


def test_the_viterbi_steps_count_keeps_each_calls_longest_row():
    """K1 on the CPU writes the count as on the card: in the row of the call
    begun last, the longest row's steps (its extent + 6, at most T) and T;
    nothing before a call has begun, the largest of two launches in a call,
    and ``reset`` clears it."""
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda

    trellis = tuple(torch.from_numpy(a) for a in viterbi._trellis())
    trellis = (trellis[0].long(), *trellis[1:])
    v = torch.zeros(3, 2 * 40)
    viterbi_cuda.viterbi_decode(v, trellis, n_steps=torch.tensor([1, 2, 3]), entry="rx")
    assert profiling.counts("rx", "viterbi_steps") == []  # no call begun
    for extents in ([3, 20, 5], [0, 0, 0], [38, 1, 2]):
        profiling.stamp("rx", "start", v)
        viterbi_cuda.viterbi_decode(v, trellis, n_steps=torch.tensor(extents), entry="rx")
    viterbi_cuda.viterbi_decode(v[:1], trellis, n_steps=torch.tensor([1]), entry="rx")
    assert profiling.counts("rx", "viterbi_steps") == [(26, 40), (6, 40), (40, 40)]
    profiling.stamp("rx", "start", v)
    viterbi_cuda.viterbi_decode(v, trellis, entry="rx")  # no extents: every row runs T
    assert profiling.counts("rx", "viterbi_steps")[-1] == (40, 40)
    profiling.reset()
    assert profiling.counts("rx", "viterbi_steps") == []


def test_the_summary_line_prints_the_viterbi_steps():
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda

    trellis = tuple(torch.from_numpy(a) for a in viterbi._trellis())
    trellis = (trellis[0].long(), *trellis[1:])
    v = torch.zeros(2, 2 * 50)
    for extents in ([4, 9], [14, 0]):
        profiling.stamp("rx", "start", v)
        viterbi_cuda.viterbi_decode(v, trellis, n_steps=torch.tensor(extents), entry="rx")
    line = profiling.summary("rx", calls=2, seconds=1.0, busy=(), blocked=())
    assert line.endswith("viterbi_steps=17.5/50 (35.0%)"), line


def test_the_dynamic_streamer_counts_its_viterbi_steps_on_the_cpu():
    """``BlockStreamer(spec=None)`` on the CPU: one count a call, each the
    longest row's steps of its K1 pass, within the envelope."""
    from jrc_tpu_torch.ops import dynamic_rx

    cfg = OFDMConfig()
    frames = [f.samples for f in capture.load_mixed_frames()]
    block_len, max_payload = 1 << 13, 96
    s = BlockStreamer(cfg, None, block_len=block_len, max_frames=4, max_payload=max_payload,
                      device="cpu")
    cap, _ = capture.build_mixed_capture(frames[:3], 2 * block_len, seed=4)
    s.push(cap)
    results = list(s.process_available())
    t = dynamic_rx.max_trellis_bits(max_payload)
    got = profiling.counts("rx", "viterbi_steps")
    assert len(got) == s.stats.calls == len(results) >= 1
    assert all(env == t and 6 <= steps <= t for steps, env in got), got


def test_the_streamer_counts_its_detect_cands_and_the_line_prints_them():
    """``BlockStreamer`` on the CPU: one ``detect_cands`` count a call, the
    candidates its block fed to the suppression (its triggers: the frames
    and the pinned frames' few extra ones), out of 4·max_frames; the
    summary line prints it before ``viterbi_steps``."""
    cfg = OFDMConfig()
    frames = [f.samples for f in capture.load_mixed_frames()]
    block_len = 1 << 13
    s = BlockStreamer(cfg, None, block_len=block_len, max_frames=4, max_payload=96,
                      device="cpu")
    cap, placed = capture.build_mixed_capture(frames[:3], 2 * block_len, seed=4)
    s.push(cap)
    results = list(s.process_available())
    got = profiling.counts("rx", "detect_cands")
    assert len(got) == s.stats.calls == len(results) >= 1
    assert all(env == 16 and 1 <= fed <= env for fed, env in got), got
    line = profiling.summary("rx", calls=len(results), seconds=1.0, busy=(), blocked=())
    assert " detect_cands=" in line and line.index("detect_cands") < line.index("viterbi_steps")
