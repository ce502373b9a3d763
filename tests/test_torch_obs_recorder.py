"""The port's flight recorder, trace context and lock registry.

The recorder keeps a bounded ring, appends each event to its JSONL file
when armed (a torn tail line is skipped on read), dumps atomically,
filters by run_id, and its event catalog is the JAX package's.  The
process-default recorder writes a file only where WITT_OBS_DIR says.
The trace context and the lock tracer behave as the JAX package's.
"""

import json
import os
import threading

import pytest

from wittgenstein_tpu.obs import recorder as jrec
from wittgenstein_tpu_torch.obs import context as tctx
from wittgenstein_tpu_torch.obs import recorder as trec
from wittgenstein_tpu_torch.runtime import locks as tlocks


def test_event_kinds_equal_jax():
    assert trec.KNOWN_KINDS == jrec.KNOWN_KINDS
    assert (trec.LIVE_BASENAME, trec.DUMP_BASENAME, trec.ENV_DIR) == \
        (jrec.LIVE_BASENAME, jrec.DUMP_BASENAME, jrec.ENV_DIR)
    for kind in ("search-generation", "search-resume", "search-complete", "search-pinned",
                 "checkpoint", "lock-order-violation"):
        assert kind in trec.KNOWN_KINDS


def test_ring_bound_and_reserved_keys():
    rec = trec.FlightRecorder(capacity=5)
    for i in range(12):
        rec.record("chunk", i=i)
    evs = rec.events()
    assert len(rec) == 5 and [e["i"] for e in evs] == list(range(7, 12))
    assert [e["seq"] for e in evs] == list(range(7, 12))
    ev = rec.record("chunk", ts=1, seq=99, gone=None, kept=0)
    assert ev["kind"] == "chunk" and ev["seq"] == 12 and ev["ts"] != 1
    assert "gone" not in ev and ev["kept"] == 0
    with pytest.raises(ValueError):
        trec.FlightRecorder(capacity=0)


def test_run_id_filter_and_context():
    rec = trec.FlightRecorder()
    a = tctx.mint_context("search")
    b = a.child(run_id="other", chunk_seq=3)
    rec.record("search-generation", ctx=a, gen=0)
    rec.record("search-generation", ctx=b, gen=1)
    rec.record("search-complete")
    assert [e["gen"] for e in rec.events(run_id=a.run_id)] == [0]
    assert rec.events(run_id="other")[0]["chunk_seq"] == 3
    assert a.ids() == {"run_id": a.run_id}
    assert a.run_id.startswith("search-") and len(a.run_id.split("-")) == 3
    with pytest.raises(Exception):
        a.run_id = "x"


def test_armed_tail_and_torn_line(tmp_path):
    path = tmp_path / "live" / trec.LIVE_BASENAME
    rec = trec.FlightRecorder(path=str(path))
    for i in range(3):
        rec.record("checkpoint", gen=i)
        assert len(path.read_text().splitlines()) == i + 1
    with open(path, "a") as f:
        f.write('{"ts": 1, "kind": "chu')  # a writer killed mid-line
    evs = trec.read_events(str(path))
    assert [e["gen"] for e in evs] == [0, 1, 2]
    assert jrec.read_events(str(path)) == evs
    other = tmp_path / "other.jsonl"
    other.write_text(json.dumps({"ts": 0.5, "seq": 0, "kind": "resume"}) + "\n")
    merged = trec.read_events([str(path), str(other), str(tmp_path / "missing")])
    assert merged[0]["kind"] == "resume" and len(merged) == 4


def test_atomic_dump(tmp_path):
    rec = trec.FlightRecorder()
    for i in range(4):
        rec.record("chunk", i=i)
    out = rec.dump(str(tmp_path / "d" / trec.DUMP_BASENAME))
    lines = [json.loads(x) for x in open(out)]
    assert [e["i"] for e in lines] == [0, 1, 2, 3]
    assert not [n for n in os.listdir(tmp_path / "d") if ".tmp." in n]


def test_default_recorder_and_dump_paths(tmp_path, monkeypatch):
    monkeypatch.delenv(trec.ENV_DIR, raising=False)
    trec.reset_default_recorder()
    try:
        rec = trec.get_recorder()
        assert rec is trec.get_recorder() and rec.path is None
        assert trec.failure_dump_paths() == []
        monkeypatch.setenv(trec.ENV_DIR, str(tmp_path))
        trec.reset_default_recorder()
        rec = trec.get_recorder()
        rec.record("search-pinned")
        assert (tmp_path / trec.LIVE_BASENAME).is_file()
        assert trec.failure_dump_paths("ck") == [os.path.join("ck", trec.DUMP_BASENAME),
                                                 os.path.join(str(tmp_path), trec.DUMP_BASENAME)]
    finally:
        trec.reset_default_recorder()


def test_threads_lose_no_event():
    rec = trec.FlightRecorder(capacity=10_000)

    def work(k):
        for i in range(200):
            rec.record("chunk", k=k, i=i)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(rec) == 1600
    assert sorted(e["seq"] for e in rec.events()) == list(range(1600))


def test_lock_registry_and_tracer(monkeypatch):
    assert [s.name for s in tlocks.LOCK_HIERARCHY] == ["obs.recorder_default", "obs.recorder"]
    with pytest.raises(ValueError, match="not in LOCK_HIERARCHY"):
        tlocks.make_lock("nope")
    monkeypatch.delenv(trec.ENV_DIR, raising=False)
    trec.reset_default_recorder()
    tlocks.reset_lock_trace()
    tlocks.arm_lock_trace(True)
    try:
        outer, inner = tlocks.make_lock("obs.recorder_default"), tlocks.make_lock("obs.recorder")
        with outer:
            with inner:
                pass
        assert tlocks.lock_trace_status()["violationCount"] == 0
        with inner:
            with outer:  # a rank inversion
                pass
        status = tlocks.lock_trace_status()
        assert status["violationCount"] == 1
        assert status["violations"][0]["kind"] == "rank inversion"
        assert status["perLock"]["obs.recorder"]["acquisitions"] >= 2
        evs = trec.get_recorder().events()
        assert [e["kind"] for e in evs][-1] == "lock-order-violation"
    finally:
        tlocks.arm_lock_trace(False)
        tlocks.reset_lock_trace()
        trec.reset_default_recorder()
