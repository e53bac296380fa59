"""The port's spans and flight recorder (``telemetry/tracing.py``,
``telemetry/recorder.py``) against the JAX package's, and where the port
wires them: the fleet's spans (``clean_fleet(tracer=, trace=)``, the
multi-host steal's trace stitching), ``--fleet --trace-out`` and
``--flight-recorder``, the watchdog's dump (``resilience/retry.py``) and
the journal's torn-heal breadcrumb.  On the CPU, small archives."""

import json
import os
import time

import numpy as np
import pytest

from iterative_cleaner_tpu.telemetry import recorder as ref_recorder
from iterative_cleaner_tpu.telemetry import tracing as ref_tracing
from iterative_cleaner_torch import CleanConfig, cli
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.parallel.distributed import HostTopology
from iterative_cleaner_torch.parallel.fleet import (
    bucket_work_key,
    clean_fleet,
)
from iterative_cleaner_torch.resilience import (
    FleetJournal,
    ResiliencePlan,
    StageTimeout,
    call_with_deadline,
)
from iterative_cleaner_torch.telemetry import recorder, tracing

CFG = CleanConfig(device="cpu", max_iter=2)


def _spans(tracer_mod, recorder_obj=None):
    """One small request tree recorded by ``tracer_mod``'s Tracer: a
    root, a child with an event and an attribute, an errored child and a
    second host's span; returns the finished span dicts."""
    t = tracer_mod.Tracer(host="h0", recorder=recorder_obj)
    root = t.start("request", subsystem="serve", lane="serve",
                   request_id="r1")
    with t.span("execute", trace_id=root.trace_id, parent_id=root.span_id,
                subsystem="fleet", lane="bucket:4x8x16:0") as s:
        s.event("retry", stage="load", attempt=0)
        s.set("n_items", 2)
    with pytest.raises(ValueError):
        with t.span("write", trace_id=root.trace_id,
                    parent_id=root.span_id, subsystem="fleet",
                    lane="io"):
            raise ValueError("disk full")
    root.end()
    t2 = tracer_mod.Tracer(host="h1")
    t2.start("serve_bucket", trace_id=root.trace_id, parent_id=root.span_id,
             subsystem="fleet", lane="bucket:4x8x16:0").end("claim_lost")
    return t.spans_for(root.trace_id) + t2.spans_for(root.trace_id)


def test_span_records_have_the_references_fields():
    got, want = _spans(tracing), _spans(ref_tracing)
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    assert [(d["name"], d["status"], d["host"], d["lane"]) for d in got] \
        == [(d["name"], d["status"], d["host"], d["lane"]) for d in want]
    assert tracing.SPAN_SCHEMA == ref_tracing.SPAN_SCHEMA
    (write,) = [d for d in got if d["name"] == "write"]
    assert write["status"] == "error"
    assert write["events"][0]["name"] == "error"


def test_render_perfetto_equals_the_references():
    """The same span dicts render to the same Perfetto document in both
    packages (host pid lanes, lane tids, complete and instant events)."""
    spans = _spans(tracing)
    assert tracing.render_perfetto(spans) == ref_tracing.render_perfetto(
        spans)
    doc = tracing.render_perfetto(spans)
    phases = sorted({e["ph"] for e in doc["traceEvents"]})
    assert phases == ["M", "X", "i"]


def test_spool_fold_is_multi_process_and_torn_tail_tolerant(tmp_path):
    """Two tracers (two hosts) spool to one file; a torn tail line and a
    foreign line are skipped; each package reads the other's spool; the
    Perfetto render is atomic and holds both hosts."""
    out = str(tmp_path / "trace.json")
    spool = tracing.spool_path_for(out)
    assert spool == ref_tracing.spool_path_for(out)
    a = tracing.Tracer(host="h0", spool_path=spool)
    b = ref_tracing.Tracer(host="h1", spool_path=spool)
    with a.span("fleet", subsystem="fleet") as root:
        pass
    with b.span("serve_bucket", trace_id=root.trace_id,
                parent_id=root.span_id, subsystem="fleet"):
        pass
    with open(spool, "a") as f:
        f.write('{"schema": "other"}\n{"schema": "icln-span/1", "tra')
    got = tracing.read_spans(spool)
    assert got == ref_tracing.read_spans(spool)
    assert [s["host"] for s in got] == ["h0", "h1"]
    a.flush_perfetto(out)
    with open(out) as f:
        doc = json.load(f)
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"host h0", "host h1"}


def test_tracer_store_is_bounded_and_maybe_span_is_free():
    t = tracing.Tracer()
    for i in range(t.MAX_TRACES + 5):
        t.start("x", trace_id="t%d" % i).end()
    assert t.spans_for("t0") == [] and t.spans_for("t%d" % (
        t.MAX_TRACES + 4))
    with tracing.maybe_span(None, "load") as s:
        assert s is None
    assert tracing.span_context(None) is None
    assert tracing.valid_trace_id("req-7f3a") \
        and not tracing.valid_trace_id("a b")


# ---------------------------------------------------------- the recorder

def _recorded(mod):
    rec = mod.FlightRecorder(path=None, ring=3)
    for i in range(5):
        rec.event("fleet", "retry", attempt=i)
    rec.record("serve", "span", {"name": "request"})
    return rec


def test_recorder_snapshot_has_the_references_keys():
    got = _recorded(recorder).snapshot("sigquit")
    want = _recorded(ref_recorder).snapshot("sigquit")
    assert sorted(got) == sorted(want)
    assert got["schema"] == want["schema"] == "icln-flight/1"
    assert {k: [sorted(e) for e in v] for k, v in got["rings"].items()} == \
        {k: [sorted(e) for e in v] for k, v in want["rings"].items()}
    # the ring keeps the newest entries
    assert [e["attempt"] for e in got["rings"]["fleet"]] == [2, 3, 4]
    assert got["threads"]


def test_recorder_dumps_are_numbered_and_never_raise(tmp_path):
    rec = recorder.FlightRecorder(path=str(tmp_path / "box.json"))
    rec.event("serve", "boot")
    first = rec.dump("one")
    second = rec.dump("two")
    assert first.endswith("box.json") and second.endswith("box.1.json")
    with open(second) as f:
        assert json.load(f)["reason"] == "two"
    bad = recorder.FlightRecorder(path=str(tmp_path / "no" / "dir.json"))
    assert bad.dump("x") is None
    assert recorder.FlightRecorder().dump("x") is None


@pytest.fixture
def active_recorder(tmp_path):
    rec = recorder.FlightRecorder(path=str(tmp_path / "flight.json"))
    recorder.set_active(rec)
    yield rec
    recorder.set_active(None)


def test_watchdog_trip_dumps_the_active_recorder(active_recorder):
    """A stage past its deadline: ``StageTimeout``, a ``watchdog_trip``
    event on the span and in the recorder's retry ring, and the black box
    dumped with the abandoned attempt's thread in it."""
    t = tracing.Tracer()
    with pytest.raises(StageTimeout):
        with t.span("execute") as span:
            call_with_deadline(lambda: time.sleep(2.0), 0.1, "execute",
                               span=span)
    path = active_recorder.path
    with open(path) as f:
        box = json.load(f)
    assert box["reason"] == "watchdog-trip:execute"
    assert box["rings"]["retry"][-1]["name"] == "watchdog_trip"
    assert any("icln-deadline-execute" in k for k in box["threads"])
    (done,) = t.recent(1)
    assert done["events"][0]["name"] == "watchdog_trip"


def test_journal_torn_heal_leaves_a_breadcrumb(tmp_path, active_recorder):
    path = str(tmp_path / "j.jsonl")
    j = FleetJournal(path)
    j.record_request("r1", "accepted", paths=["/a"])
    with open(path, "a") as f:
        f.write('{"schema": "icln-fleet-journal/1", "ev')   # a torn tail
    j.record_request("r1", "done")
    ring = active_recorder.snapshot("x")["rings"]["journal"]
    assert ring[-1]["name"] == "torn_heal"
    assert j.request_states()["r1"]["state"] == "done"


# --------------------------------------------------- the fleet's spans

def _fleet_files(tmp_path, geometries, seed0=30):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed0 + i)
        paths.append(str(tmp_path / ("f%02d.npz" % i)))
        save_archive(ar, paths[-1])
    return paths


def test_clean_fleet_spans_stitch_under_the_callers_trace(tmp_path):
    """``clean_fleet(tracer=, trace=)``: one ``fleet`` root parented by
    the caller's span, a ``group`` and an ``execute`` span per group, a
    ``load`` and a ``write`` span per archive, all under one trace id;
    each journaled ``done`` line carries the trace context; the results
    equal an untraced fleet's."""
    paths = _fleet_files(tmp_path, [(6, 8, 16)] * 3 + [(4, 8, 16)])
    t = tracing.Tracer()
    root = t.start("execute", subsystem="serve")
    j = FleetJournal(str(tmp_path / "j.jsonl"))
    written = []
    rep = clean_fleet(paths, CFG, group_size=2, tracer=t,
                      trace=root.context(),
                      write_fn=lambda p, ar, r: written.append(p),
                      resilience=ResiliencePlan(journal=j))
    root.end()
    plain = clean_fleet(paths, CFG, group_size=2)
    for p in paths:
        np.testing.assert_array_equal(rep.results[p].final_weights,
                                      plain.results[p].final_weights)
    spans = t.spans_for(root.trace_id)
    count = {}
    for s in spans:
        count[s["name"]] = count.get(s["name"], 0) + 1
    assert count == {"execute": 1 + 3, "fleet": 1, "group": 3, "load": 4,
                     "write": 4}
    (fleet_span,) = [s for s in spans if s["name"] == "fleet"]
    assert fleet_span["parent_id"] == root.span_id
    assert fleet_span["attrs"]["n_cleaned"] == 4
    for s in spans:
        if s["name"] in ("load", "write", "group"):
            assert s["parent_id"] == fleet_span["span_id"]
    lines = [json.loads(ln) for ln in open(j.path)]
    assert all(ln["trace"]["trace_id"] == root.trace_id
               for ln in lines if ln.get("event") == "done")


def test_stolen_bucket_continues_the_victims_trace(tmp_path):
    """A host stealing an expired lease parents its ``serve_bucket`` span
    on the trace context the victim's claim line carries."""
    from iterative_cleaner_torch.parallel.fleet import (
        _default_shape_fn,
        bucket_host,
    )

    paths = _fleet_files(tmp_path, [(6, 8, 16), (4, 8, 16), (5, 8, 16)])
    j = FleetJournal(str(tmp_path / "shared.jsonl"))
    keys = {_default_shape_fn(p) for p in paths}
    foreign = [k for k in keys if bucket_host(k, 2) == 1]
    assert foreign, "no bucket hashes to host 1"
    for k in foreign:
        j.record_claim(bucket_work_key(k), host=1, nonce="dead", ttl_s=1.0,
                       now=time.time() - 60,
                       trace={"trace_id": "victimtrace", "span_id": "v1"})
    t = tracing.Tracer(host="h0")
    rep = clean_fleet(paths, CFG, hosts=HostTopology(0, 2), tracer=t,
                      resilience=ResiliencePlan(journal=j))
    assert rep.ok and rep.n_stolen == len(foreign)
    stolen = [s for s in t.spans_for("victimtrace")
              if s["name"] == "serve_bucket"]
    assert len(stolen) == len(foreign)
    assert all(s["name"] == "serve_bucket" and s["parent_id"] == "v1"
               and s["attrs"]["stolen"] for s in stolen)
    assert stolen[0]["events"][0]["name"] == "stolen"


def test_cli_fleet_trace_out_and_flight_recorder(tmp_path, monkeypatch):
    """``--fleet --trace-out`` renders the fleet's spans as Perfetto; a
    watchdog trip under ``--flight-recorder`` dumps the black box."""
    monkeypatch.chdir(tmp_path)
    paths = _fleet_files(tmp_path, [(6, 8, 16)] * 2)
    names = [os.path.basename(p) for p in paths]
    assert cli.main(["--device", "cpu", "-q", "--fleet", "--trace-out",
                     "t.json", *names]) == 0
    with open("t.json") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"fleet", "group", "execute",
                                          "load", "write"}
    assert len({e["args"]["trace_id"] for e in spans}) == 1
    assert os.path.exists("t.json.spans.jsonl")
    monkeypatch.setenv("ICLEAN_FAULT_HANG_S", "30")
    assert cli.main(["--device", "cpu", "-q", "--fleet", "--faults",
                     "exec:hang@1", "--stage-timeout", "0.5",
                     "--flight-recorder", "box.json", "-o", "x.npz",
                     *names]) == 1
    with open("box.json") as f:
        assert json.load(f)["reason"] == "watchdog-trip:execute"
    assert recorder.get_active() is None


def test_online_session_spans_parent_under_the_request(tmp_path):
    from iterative_cleaner_torch.online import OnlineSession, StreamMeta

    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=16, seed=3)
    t = tracing.Tracer()
    sess = OnlineSession(StreamMeta.from_archive(ar), dataclasses_replace(
        CFG, stream_reconcile_every=2), tracer=t, trace_id="req",
        parent_span_id="root")
    for tile in ar.total_intensity():
        sess.ingest(tile)
    sess.close()
    names = [s["name"] for s in t.spans_for("req")]
    assert names.count("subint") == 4 and names.count("reconcile") == 2
    assert "close_reconcile" in names
    assert {s["parent_id"] for s in t.spans_for("req")} == {"root"}


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)
