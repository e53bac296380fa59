"""The serve daemon of the port (``iterative_cleaner_torch/serve/``,
``--serve``) against the JAX package's, on the CPU (``device="cpu"``:
the kernels' plain versions).

- The parser repair: the reference parser's daemon flags parse, and what
  it refuses the port refuses (exit 2); the route flags exit 2 with the
  port's message; ``--no-donate`` changes nothing; ``--selfcheck`` and
  ``--journal-fsck`` name item 8.
- Requests and admission: ``parse_request``, ``request_key`` and the
  scheduler's pop order, caps, queue bound and expiry give the JAX
  package's fields, order and rejection reasons on the same payloads and
  clock; the route knobs are refused at intake, and ``backend: "numpy"``
  parses as the reference parses it.
- The daemon in process: an HTTP round trip whose outputs are bit-equal
  to the port's ``clean_archive`` and mask-equal to the JAX default
  route, its journal read by the JAX package's ``FleetJournal``; the 429
  and 503 answers; a stream request's close bit-equal to the port's
  ``OnlineSession``; the result cache answering with no clean; a
  ``backend: "numpy"`` request cleaned on the engine under its own
  identity.
- The subprocess contracts: kill -9 and a restart clean no archive
  twice, SIGTERM drains (exit 0) and a second signal forces exit 70.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.config import ServeConfig as RefServeConfig
from iterative_cleaner_tpu.resilience import FleetJournal as RefJournal
from iterative_cleaner_tpu.serve import Rejection as RefRejection
from iterative_cleaner_tpu.serve import ServeScheduler as RefScheduler
from iterative_cleaner_tpu.serve import parse_request as ref_parse_request
from iterative_cleaner_tpu.serve import request_key as ref_request_key
from iterative_cleaner_torch import CleanConfig, cli
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.config import ServeConfig
from iterative_cleaner_torch.io import (
    load_archive,
    make_synthetic_archive,
    save_archive,
)
from iterative_cleaner_torch.online import OnlineSession, StreamMeta
from iterative_cleaner_torch.resilience import FleetJournal
from iterative_cleaner_torch.serve import (
    Rejection,
    RequestError,
    ServeDaemon,
    ServeScheduler,
    parse_request,
    request_key,
)
from tests.conftest import repo_subprocess_env

CFG = CleanConfig(device="cpu", max_iter=3)
# each wait in this file ends by this deadline (seconds)
WAIT_S = 60


def _write(tmp_path, geometries, ext=".npz", seed0=70):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed0 + i)
        p = str(tmp_path / ("serve_%02d%s" % (i, ext)))
        save_archive(ar, p)
        paths.append(p)
    return paths


# ------------------------------------------------------------- the parser

SERVE_REFUSALS = [
    # the intake knobs without --serve
    ["--spool", "s", "x.npz"],
    ["--http-port", "0", "x.npz"],
    ["--max-inflight", "2", "x.npz"],
    ["--join", "x.npz"],
    ["--member-ttl", "5", "x.npz"],
    ["--result-cache", "x.npz"],
    # --serve's own refusals
    ["--serve", "--spool", "s", "x.npz"],
    ["--serve"],
    ["--serve", "--spool", "s", "--join"],
    ["--serve", "--spool", "s", "--member-ttl", "5"],
    ["--serve", "--spool", "s", "--fleet"],
    ["--serve", "--spool", "s", "--batch", "2"],
    ["--serve", "--spool", "s", "--stream", "4"],
    ["--serve", "--spool", "s", "-o", "out.npz"],
    ["--serve", "--spool", "s", "--model", "quicklook"],
    ["--serve", "--spool", "s", "--backend", "numpy"],
    ["--serve", "--spool", "s", "--mux", "d"],
    # the spans and the recorder without --fleet or --serve
    ["--trace-out", "t.json", "x.npz"],
    ["--flight-recorder", "f.json", "x.npz"],
    # --selfcheck's format without --selfcheck
    ["--format", "json", "x.npz"],
    ["--selfcheck-format", "text", "x.npz"],
]


@pytest.mark.parametrize("argv", SERVE_REFUSALS, ids=" ".join)
def test_cli_serve_refusals_are_the_reference_parsers(argv, tmp_path,
                                                      monkeypatch):
    """Every daemon flag parses in both packages, and what the
    reference's parser refuses (exit 2) the port's refuses."""
    for name in ("ICLEAN_SPOOL", "ICLEAN_HTTP_PORT", "ICLEAN_JOIN",
                 "ICLEAN_MUX"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ICLEAN_PROBE_TIMEOUT", "0")
    monkeypatch.chdir(tmp_path)
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2, main


@pytest.mark.parametrize("flag", cli.ROUTE_FLAGS)
def test_cli_route_flags_exit_2_with_the_ports_message(flag, tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ei:
        cli.main(["--device", "cpu", flag, "on", "x.npz"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "one route" in err


@pytest.mark.parametrize("argv", [["--selfcheck"],
                                  ["--selfcheck", "--format", "json"],
                                  ["--journal-fsck", "j.jsonl"]])
def test_cli_selfcheck_and_fsck_name_item_8(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 8"):
        cli.main(["--device", "cpu", *argv])


def test_cli_no_donate_changes_nothing(tmp_path, monkeypatch):
    """``--no-donate`` (and ``--no_donate``) is accepted and the output
    is byte-identical to the run without it."""
    monkeypatch.chdir(tmp_path)
    ar, _ = make_synthetic_archive(nsub=6, nchan=8, nbin=16, seed=5)
    save_archive(ar, "a.icar")
    outs = []
    for extra in ([], ["--no-donate"], ["--no_donate"]):
        assert cli.main(["--device", "cpu", "-q", "-l", *extra, "-o",
                         "out%d.icar" % len(outs), "a.icar"]) == 0
        with open("out%d.icar" % len(outs), "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == outs[2]


def test_cli_serve_builds_the_reference_serve_config(tmp_path, monkeypatch):
    """``--serve`` with every daemon flag hands the daemon the
    ServeConfig the reference's ``ServeConfig.from_env`` builds from the
    same values (bare ``--mux`` included), and its base config on the
    chosen device."""
    import iterative_cleaner_torch.serve as serve

    monkeypatch.chdir(tmp_path)
    for name in ("ICLEAN_SPOOL", "ICLEAN_HTTP_PORT", "ICLEAN_JOIN",
                 "ICLEAN_MUX", "ICLEAN_FLIGHT_RECORDER", "ICLEAN_TRACE_OUT",
                 "ICLEAN_PROFILE_DIR", "ICLEAN_RESULT_CACHE"):
        monkeypatch.delenv(name, raising=False)
    got = {}

    def fake_run_serve(serve_cfg, cfg, **kw):
        got["serve"], got["cfg"] = serve_cfg, cfg
        return 0

    monkeypatch.setattr(serve, "run_serve", fake_run_serve)
    assert cli.main(["--device", "cpu", "--serve", "--spool", "sp",
                     "--http-port", "0", "--max-inflight", "3",
                     "--journal", "j.jsonl", "--join", "--member-ttl", "9",
                     "--result-cache", "--trace-out", "t.json",
                     "--flight-recorder", "", "--profile-dir", "prof",
                     "--mux", "--mux-max-batch", "4", "-c", "4.5"]) == 0
    want = RefServeConfig.from_env(
        spool_dir="sp", http_port=0, max_inflight=3, journal_path="j.jsonl",
        trace_out="t.json", join=True, member_ttl_s=9.0, result_cache=True,
        flight_recorder="", profile_dir="prof", mux=True, mux_max_batch=4)
    assert dataclasses.asdict(got["serve"]) == dataclasses.asdict(want)
    assert got["cfg"].device == "cpu" and got["cfg"].chanthresh == 4.5


def test_serve_config_env_mirrors_match_the_reference(monkeypatch):
    for name, value in (("ICLEAN_SPOOL", "/s"), ("ICLEAN_HTTP_PORT", "0"),
                        ("ICLEAN_MAX_INFLIGHT", "2"), ("ICLEAN_JOIN", "1"),
                        ("ICLEAN_MEMBER_TTL", "4"),
                        ("ICLEAN_FLIGHT_RECORDER", "f.json")):
        monkeypatch.setenv(name, value)
    assert dataclasses.asdict(ServeConfig.from_env()) == \
        dataclasses.asdict(RefServeConfig.from_env())
    with pytest.raises(ValueError, match="intake"):
        monkeypatch.delenv("ICLEAN_SPOOL")
        monkeypatch.delenv("ICLEAN_HTTP_PORT")
        ServeConfig.from_env()


# ------------------------------------------------- requests and admission

PAYLOADS = [
    {"paths": ["/d/a.npz", "/d/b.npz"], "tenant": "t1", "priority": 5,
     "deadline_s": 120.0, "overrides": {"max_iter": 3,
                                        "pulse_region": [0.2, 3, 6]},
     "trace": "req-7f3a", "id": "r1"},
    {"paths": "/d/c.npz"},
    {"kind": "stream", "id": "s1", "meta": {
        "nchan": 4, "nbin": 8, "freqs_mhz": [1, 2, 3, 4], "dm": 0.0,
        "centre_freq_mhz": 2.5, "period_s": 0.1}},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["full", "bare",
                                                   "stream"])
def test_parse_request_fields_equal_the_references(payload):
    now = 1000.0
    got = parse_request(json.dumps(payload), request_id="spool-stem",
                        base_config=CFG, now=now)
    want = ref_parse_request(json.dumps(payload), request_id="spool-stem",
                             base_config=RefConfig(), now=now)
    g, w = got.journal_fields(), want.journal_fields()
    for d in (g, w):
        d.pop("submitted_ts")
        if "trace" not in payload:
            d.pop("trace_id")   # minted at random in each
    assert g == w
    assert got.request_id == want.request_id == "spool-stem"


BAD_PAYLOADS = [
    b"\xff\xfe",
    "not json",
    "[1, 2]",
    {"paths": []},
    {"paths": [""]},
    {"paths": ["/a"], "priority": "high"},
    {"paths": ["/a"], "tenant": ""},
    {"paths": ["/a"], "deadline_s": -1},
    {"paths": ["/a"], "overrides": {"output": "x"}},
    {"paths": ["/a"], "overrides": {"max_iter": 0}},
    {"paths": ["/a"], "overrides": {"pulse_region": ["x", 1, 2]}},
    {"paths": ["/a"], "trace": "bad trace!"},
    {"paths": ["/a"], "bogus": 1},
    {"paths": ["/a"], "kind": "batch"},
    {"kind": "stream", "paths": ["/a"]},
    {"paths": ["/a"], "meta": {"nchan": 4}},
    {"paths": ["/a"], "id": "a/b"},
]


@pytest.mark.parametrize("payload", BAD_PAYLOADS,
                         ids=lambda p: str(p)[:40])
def test_parse_request_refusals_are_the_references(payload):
    raw = payload if isinstance(payload, (bytes, str)) else json.dumps(
        payload)
    with pytest.raises(RequestError):
        parse_request(raw, base_config=CFG)
    with pytest.raises(ValueError):   # the reference's RequestError
        ref_parse_request(raw, base_config=RefConfig())


@pytest.mark.parametrize("knob", ["fft_mode", "median_impl", "stats_impl"])
def test_route_knob_overrides_are_refused_with_the_ports_message(knob):
    with pytest.raises(RequestError, match="one route"):
        parse_request({"paths": ["/a"], "overrides": {knob: "auto"}},
                      base_config=CFG)


def test_numpy_backend_override_parses_as_the_references():
    """``backend: "numpy"`` (the reference's ``OVERRIDABLE`` names it: a
    tenant may ask for the numpy oracle) is accepted by both parsers
    with the same journal fields and the same effective config."""
    from iterative_cleaner_torch.convert import config_from_reference

    payload = {"paths": ["/a"], "overrides": {"backend": "numpy"},
               "trace": "req-np"}
    got = parse_request(payload, base_config=CFG, now=1.0)
    want = ref_parse_request(payload, base_config=RefConfig(max_iter=3),
                             now=1.0)
    g, w = got.journal_fields(), want.journal_fields()
    for d in (g, w):
        d.pop("submitted_ts")
    assert g == w and g["overrides"] == {"backend": "numpy"}
    ref_cfg = want.effective_config(RefConfig(max_iter=3))
    assert ref_cfg.backend == "numpy"
    assert got.effective_config(CFG) == config_from_reference(
        ref_cfg, device="cpu")


def test_request_key_orders_as_the_reference():
    payloads = [({"paths": ["/a"], "priority": p, "deadline_s": d}, i)
                for i, (p, d) in enumerate([(0, None), (5, 10.0), (5, 5.0),
                                            (-1, 1.0), (5, None)])]
    now = 50.0
    got = sorted(range(len(payloads)), key=lambda i: request_key(
        parse_request(payloads[i][0], now=now), i))
    want = sorted(range(len(payloads)), key=lambda i: ref_request_key(
        ref_parse_request(payloads[i][0], now=now), i))
    assert got == want == [2, 1, 4, 0, 3]


def _drive_scheduler(sched_cls, parse, rej_cls):
    """One admission sequence: tenant caps, the queue bound, a
    duplicate, an expiry, pops and drain; returns what a caller sees."""
    sched = sched_cls(queue_limit=4, max_inflight=2)
    seen = []
    now = time.time()
    plan = [("a", "t1", 0, None), ("b", "t1", 3, None), ("c", "t1", 9, None),
            ("d", "t2", 1, 0.05), ("e", "t3", 2, None), ("a", "t4", 0, None),
            ("f", "t4", 7, None), ("g", "t5", 0, None)]
    for rid, tenant, prio, dl in plan:
        payload = {"paths": ["/x"], "id": rid, "tenant": tenant,
                   "priority": prio}
        if dl is not None:
            payload["deadline_s"] = dl
        try:
            sched.submit(parse(payload, now=now))
            seen.append(("ok", rid))
        except rej_cls as exc:
            seen.append((exc.reason, rid))
    time.sleep(0.1)                    # d's deadline passes while queued
    popped, expired = [], []
    while True:
        req, gone = sched.pop(timeout=0)
        expired += [r.request_id for r in gone]
        if req is None:
            break
        popped.append(req.request_id)
        sched.mark_done(req)
    sched.start_drain()
    try:
        sched.submit(parse({"paths": ["/x"], "id": "late"}, now=now))
    except rej_cls as exc:
        seen.append((exc.reason, "late"))
    return seen, popped, expired


def test_scheduler_order_caps_bound_and_expiry_are_the_references():
    got = _drive_scheduler(ServeScheduler, parse_request, Rejection)
    want = _drive_scheduler(RefScheduler, ref_parse_request, RefRejection)
    assert got == want
    seen, popped, expired = got
    assert ("tenant_limit", "c") in seen and ("duplicate", "a") in seen
    assert ("queue_full", "f") in seen and ("draining", "late") in seen
    assert expired == ["d"] and popped == ["b", "e", "a"]


def test_spool_claims_rejects_and_leaves_torn_files(tmp_path):
    """The spool watcher as the reference's: a claimed file renamed
    ``.accepted``, a refused or malformed one ``.rejected``, a torn one
    (a write in flight) left for the next scan, a dot-file never claimed,
    and nothing touched while draining."""
    from iterative_cleaner_torch.serve import SpoolWatcher
    from iterative_cleaner_torch.telemetry import MetricsRegistry

    spool = str(tmp_path / "spool")
    reg = MetricsRegistry()
    seen = []

    def on_request(req, _path):
        if req.tenant == "full":
            raise Rejection("queue_full", "full up")
        seen.append(req.request_id)

    w = SpoolWatcher(spool, on_request=on_request, registry=reg,
                     base_config=CFG)
    _spool_submit(spool, "good", {"paths": ["/d/a.npz"]})
    _spool_submit(spool, "pressed", {"paths": ["/d/a.npz"],
                                     "tenant": "full"})
    with open(os.path.join(spool, "broken.json"), "w") as f:
        f.write('{"paths": [}')
    with open(os.path.join(spool, "torn.json"), "w") as f:
        f.write('{"paths": ["/d/a')
    with open(os.path.join(spool, ".partial.json"), "w") as f:
        f.write("{}")
    assert w.scan_once() == 1 and seen == ["good"]
    names = sorted(os.listdir(spool))
    assert names == [".partial.json", "broken.json.rejected",
                     "good.json.accepted", "pressed.json.rejected",
                     "torn.json"]
    assert reg.counters["serve_spool_torn"] == 1
    assert reg.counters["serve_rejected_spool"] == 2
    assert w.scan_once(stop_intake=True) == 0


def test_intake_and_sched_fault_sites_fire(tmp_path):
    """The ``intake`` site leaves a spool file for the next scan and the
    ``sched`` site turns a pop into an empty one, each counted as
    ``serve_retries``: neither wedges nor loses a request."""
    from iterative_cleaner_torch.resilience import FaultInjector
    from iterative_cleaner_torch.serve import SpoolWatcher
    from iterative_cleaner_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    spool = str(tmp_path / "spool")
    seen = []
    w = SpoolWatcher(spool, on_request=lambda r, _p: seen.append(r),
                     registry=reg,
                     faults=FaultInjector("intake:err@1", seed=0,
                                          registry=reg))
    _spool_submit(spool, "r1", {"paths": ["/d/a.npz"]})
    assert w.scan_once() == 0 and "r1.json" in os.listdir(spool)
    assert w.scan_once() == 1 and [r.request_id for r in seen] == ["r1"]
    sched = ServeScheduler(queue_limit=4, max_inflight=4, registry=reg,
                           faults=FaultInjector("sched:err@1", seed=0))
    sched.submit(seen[0])
    assert sched.pop(timeout=0) == (None, [])
    assert sched.pop(timeout=0)[0].request_id == "r1"
    assert reg.counters["serve_retries"] == 2


# ------------------------------------------------- the daemon in process

def _daemon(tmp_path, base=CFG, **serve_kw):
    serve_kw.setdefault("http_port", 0)
    serve_kw.setdefault("poll_s", 0.02)
    serve_kw.setdefault("journal_path", str(tmp_path / "serve.jsonl"))
    # never the cwd default: an in-process daemon's recorder is the
    # process-wide active one while it runs
    serve_kw.setdefault("flight_recorder", str(tmp_path / "flight.json"))
    return ServeDaemon(ServeConfig(**serve_kw), base, quiet=True)


def _start(daemon):
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    deadline = time.time() + WAIT_S
    while daemon._httpd is None:
        assert time.time() < deadline, "daemon never bound its port"
        time.sleep(0.01)
    return t, "http://127.0.0.1:%d" % daemon._httpd.server_address[1]


def _stop(daemon, t):
    daemon._on_signal(signal.SIGTERM, None)
    t.join(WAIT_S)
    assert not t.is_alive()


def _get(url, expect=200):
    try:
        r = urllib.request.urlopen(url, timeout=WAIT_S)
        assert r.status == expect
        return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        assert exc.code == expect, (exc.code, exc.read())
        return json.loads(exc.read())


def _post(url, doc, expect=200):
    req = urllib.request.Request(url, data=json.dumps(doc).encode())
    try:
        r = urllib.request.urlopen(req, timeout=WAIT_S)
        assert r.status == expect
        return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        assert exc.code == expect, (exc.code, exc.read())
        return json.loads(exc.read())


def _wait_done(url, rid):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        state = _get(url + "/requests/" + rid, expect=200)
        if state["state"] in ("done", "failed"):
            return state
        time.sleep(0.05)
    pytest.fail(f"request {rid} never finished")


def test_daemon_refuses_a_missing_card(tmp_path):
    """``device="cuda"`` (the default) with no card: the daemon does not
    start (the tests' CPU has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _daemon(tmp_path, base=CleanConfig())


def test_daemon_http_round_trip_bit_equal_to_clean_archive(tmp_path):
    """Two requests over HTTP (the default config and a per-request
    ``baseline_mode`` override): each output's weights bit-equal to the
    port's ``clean_archive`` with the request's config and mask-equal to
    the JAX default route; the spans of each request under its trace
    id; the journal's request lines as the JAX package reads them."""
    from iterative_cleaner_tpu.backends import clean_archive as ref_clean
    from iterative_cleaner_tpu.io import load_archive as ref_load

    paths = _write(tmp_path, [(8, 16, 32), (8, 16, 32), (6, 12, 32),
                              (8, 16, 32)])
    d = _daemon(tmp_path, spool_dir=str(tmp_path / "spool"))
    t, url = _start(d)
    try:
        assert _post(url + "/submit", {"paths": paths[:3], "id": "r1"}) == {
            "accepted": True, "id": "r1", "tenant": "default"}
        assert _wait_done(url, "r1")["n_cleaned"] == 3
        _post(url + "/submit", {"paths": paths[3:], "id": "r2",
                                "overrides": {"baseline_mode": "profile"}})
        assert _wait_done(url, "r2")["state"] == "done"
        h = _get(url + "/healthz")
        assert h["status"] == "ok" and h["completed"] == 2
        trace = _get(url + "/trace/r1")
        names = {s["name"] for s in trace["spans"]}
        assert {"request", "queue", "execute", "fleet", "load", "write",
                "group"} <= names
        assert {s["trace_id"] for s in trace["spans"]} == {
            trace["trace_id"]}
        assert _get(url + "/requests/ghost", expect=404)["error"]
        index = _get(url + "/requests")
        assert [r["id"] for r in index["requests"]] == ["r1", "r2"]
        assert "serve_completed" in _get(url + "/debug/vars")["counters"]
    finally:
        _stop(d, t)
    for p, cfg, ref_cfg in [
            *[(p, CFG, RefConfig(max_iter=3)) for p in paths[:3]],
            (paths[3], dataclasses.replace(CFG, baseline_mode="profile"),
             RefConfig(max_iter=3, baseline_mode="profile"))]:
        got = load_archive(p + "_cleaned.npz").weights
        want = clean_archive(load_archive(p), cfg).final_weights
        np.testing.assert_array_equal(got, want.astype(got.dtype))
        ref = ref_clean(ref_load(p), ref_cfg).final_weights
        np.testing.assert_array_equal(got == 0, ref == 0)
    states = RefJournal(str(tmp_path / "serve.jsonl")).request_states()
    assert states["r1"]["state"] == "done" and states["r1"]["n_cleaned"] == 3
    assert states["r2"]["overrides"] == {"baseline_mode": "profile"}


def test_daemon_backpressure_429_and_503(tmp_path):
    """No worker loop: admissions stay queued, so the tenant cap (429),
    a duplicate (409) and the drain (503) are exercised exactly."""
    from iterative_cleaner_torch.serve.http import make_server

    d = _daemon(tmp_path, max_inflight=1, queue_limit=8)
    server = make_server(d, 0)
    thr = threading.Thread(target=server.serve_forever,
                           kwargs={"poll_interval": 0.05}, daemon=True)
    thr.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        _post(url + "/submit", {"paths": ["/d/a.npz"], "id": "r1"})
        got = _post(url + "/submit", {"paths": ["/d/b.npz"], "id": "r2"},
                    expect=429)
        assert got["reason"] == "tenant_limit"
        assert _post(url + "/submit", {"paths": ["/d/a.npz"], "id": "r1"},
                     expect=409)["reason"] == "duplicate"
        assert _post(url + "/submit", {"paths": []}, expect=400)["error"]
        assert _post(url + "/profile", {}, expect=400)["error"]
        d.scheduler.start_drain()
        got = _post(url + "/submit", {"paths": ["/d/c.npz"], "id": "r3",
                                      "tenant": "other"}, expect=503)
        assert got["reason"] == "draining"
        assert d.registry.counters["serve_rejected"] == 3
    finally:
        server.shutdown()
        server.server_close()


def test_daemon_stream_close_bit_equal_to_online_session(tmp_path):
    """A ``kind: "stream"`` request fed over ``POST /stream/<id>/subint``
    (a repeated seq answers duplicate) and closed: its output and the
    journal's fields are a solo :class:`OnlineSession`'s close, bit for
    bit."""
    ar, _ = make_synthetic_archive(nsub=6, nchan=16, nbin=32, seed=9)
    meta = StreamMeta.from_archive(ar)
    cube = ar.total_intensity()
    chunks = []
    for i in range(ar.nsub):
        chunks.append(str(tmp_path / ("%03d.npy" % i)))
        np.save(chunks[-1], cube[i])
    cfg = dataclasses.replace(CFG, stream_reconcile_every=3)
    d = _daemon(tmp_path, base=cfg)
    t, url = _start(d)
    try:
        _post(url + "/submit", {"id": "live", "kind": "stream",
                                "meta": meta.to_dict()})
        for i, c in enumerate(chunks):
            assert _post(url + "/stream/live/subint",
                         {"path": c, "seq": i})["ingested"]
        assert _post(url + "/stream/live/subint",
                     {"path": chunks[0], "seq": 0})["duplicate"]
        assert _post(url + "/stream/ghost/subint", {"path": chunks[0]},
                     expect=404)["error"]
        assert _post(url + "/stream/live/close", {})["closed"]
        state = _wait_done(url, "live")
        assert "live" in _get(url + "/quality")["streams"] \
            or state["state"] == "done"
    finally:
        _stop(d, t)
    assert state["state"] == "done" and state["n_subints"] == ar.nsub
    solo = OnlineSession(meta, cfg)
    for i in range(ar.nsub):
        solo.ingest(cube[i])
    want = solo.close()
    got = load_archive(state["out"])
    np.testing.assert_array_equal(got.weights, want.archive.weights)
    assert state["reconciles"] == want.reconciles
    assert state["recompiles_steady"] == 0


def test_daemon_result_cache_answers_without_a_clean(tmp_path):
    """``--result-cache``: a resubmission of the same archives under the
    same config is answered from the journal's verified index, with no
    load, clean or write (the fleet's counters do not move)."""
    paths = _write(tmp_path, [(6, 12, 32), (6, 12, 32)])
    d = _daemon(tmp_path, result_cache=True)
    t, url = _start(d)
    try:
        _post(url + "/submit", {"paths": paths, "id": "first"})
        assert _wait_done(url, "first")["n_cleaned"] == 2
        before = dict(d.registry.counters)
        _post(url + "/submit", {"paths": paths, "id": "again"})
        again = _wait_done(url, "again")
        after = dict(d.registry.counters)
    finally:
        _stop(d, t)
    assert again["state"] == "done" and again["n_cached"] == 2
    assert again["n_cleaned"] == 0
    for k in ("fleet_cleaned", "fleet_archives", "batch_archives"):
        assert after.get(k) == before.get(k), k
    assert after["serve_cache_hits"] == 2


def test_daemon_serves_a_numpy_backend_request_on_the_engine(tmp_path):
    """A spool request overriding ``backend: "numpy"`` is served through
    the fleet's batched clean, as the reference's daemon serves it: its
    outputs bit-equal to ``clean_archive`` under the torch engine, its
    journal lines keyed by its own config's hash (``backend`` included,
    as the reference's ``config_hash`` includes it), and its result-cache
    entry apart from a torch request's on the same archives."""
    from iterative_cleaner_tpu.utils.checkpoint import (
        config_identity as ref_config_identity,
    )
    from iterative_cleaner_torch.utils.checkpoint import (
        config_hash,
        config_identity,
    )

    paths = _write(tmp_path, [(6, 12, 32), (6, 12, 32)], seed0=90)
    numpy_cfg = dataclasses.replace(CFG, backend="numpy")
    jpath = str(tmp_path / "serve.jsonl")
    spool = str(tmp_path / "spool")
    d = _daemon(tmp_path, spool_dir=spool, result_cache=True)
    t, url = _start(d)
    try:
        _spool_submit(spool, "np1", {"paths": paths,
                                     "overrides": {"backend": "numpy"}})
        deadline = time.time() + WAIT_S
        while not _get(url + "/requests")["requests"]:
            assert time.time() < deadline, "the spool request never arrived"
            time.sleep(0.05)
        first = _wait_done(url, "np1")
        # the fleet's done lines, keyed by the request's own config
        done_np = FleetJournal(jpath).completed(config_hash(numpy_cfg))
        done_torch = FleetJournal(jpath).completed(config_hash(CFG))
        _post(url + "/submit", {"paths": paths, "id": "np2",
                                "overrides": {"backend": "numpy"}})
        again = _wait_done(url, "np2")
        _post(url + "/submit", {"paths": paths, "id": "torch1"})
        torch1 = _wait_done(url, "torch1")
    finally:
        _stop(d, t)
    assert first["state"] == "done" and first["n_cleaned"] == 2
    # the numpy resubmission is answered from its cache entry; a torch
    # request is another identity: cleaned again
    assert again["n_cached"] == 2 and again["n_cleaned"] == 0
    assert torch1["n_cleaned"] == 2 and torch1.get("n_cached", 0) == 0
    for p in paths:
        got = load_archive(p + "_cleaned.npz").weights
        want = clean_archive(load_archive(p), CFG).final_weights
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert set(done_np) == {os.path.abspath(p) for p in paths}
    assert not done_torch
    assert config_hash(numpy_cfg) != config_hash(CFG)
    assert json.loads(config_identity(numpy_cfg))["backend"] == "numpy"
    assert json.loads(ref_config_identity(
        RefConfig(backend="numpy")))["backend"] == "numpy"
    states = RefJournal(jpath).request_states()
    assert states["np1"]["overrides"] == {"backend": "numpy"}
    assert states["np1"]["state"] == "done"


# ------------------------------------------------- subprocess contracts

SERVE_ARGS = ["--serve", "--device", "cpu", "--http-port", "0",
              "--spool", "spool", "--max_iter", "3", "--io-workers", "1"]


def _start_daemon(tmp_path, extra=(), **env):
    out_path = str(tmp_path / ("daemon.%d.out" % len(os.listdir(tmp_path))))
    outf = open(out_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "iterative_cleaner_torch", *SERVE_ARGS,
         *extra], env=repo_subprocess_env(**env), cwd=str(tmp_path),
        stdout=outf, stderr=subprocess.STDOUT)
    needle = "serve: http listening on 127.0.0.1:"
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        for line in open(out_path).read().splitlines():
            if line.startswith(needle):
                return proc, out_path, int(line[len(needle):])
        if proc.poll() is not None:
            pytest.fail("daemon exited (rc %s):\n%s"
                        % (proc.returncode, open(out_path).read()[-3000:]))
        time.sleep(0.05)
    proc.kill()
    pytest.fail("daemon never printed its port")


def _spool_submit(spool_dir, name, payload):
    os.makedirs(spool_dir, exist_ok=True)
    tmp = os.path.join(spool_dir, ".%s.tmp" % name)
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(spool_dir, name + ".json"))


def _done_lines(jpath):
    out = []
    if not os.path.exists(jpath):
        return out
    for ln in open(jpath).read().splitlines():
        try:
            e = json.loads(ln)
        except ValueError:
            continue
        if e.get("event") == "done":
            out.append(e["path"])
    return out


def _wait_state(jpath, rid, proc):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if os.path.exists(jpath):
            state = FleetJournal(jpath).request_states().get(rid, {}).get(
                "state")
            if state in ("done", "failed"):
                return state
        if proc.poll() is not None:
            pytest.fail("daemon exited early (rc %s)" % proc.returncode)
        time.sleep(0.1)
    pytest.fail("request %s never finished" % rid)


def test_serve_kill9_restart_cleans_no_archive_twice(tmp_path):
    """A request wedged mid-fleet by a load hang, ``kill -9`` after its
    first bucket journaled, and a restart on the same journal: the
    request re-runs, the journaled archives are skipped, each archive is
    journaled done once, and the outputs are the uninterrupted clean's."""
    paths = _write(tmp_path, [(6, 12, 32)] * 2 + [(8, 12, 32)] * 2,
                   ext=".icar")
    jpath = str(tmp_path / "serve.journal.jsonl")
    proc, _out, _port = _start_daemon(
        tmp_path, ["--faults", "load:hang@3"], ICLEAN_FAULT_HANG_S="600")
    _spool_submit(str(tmp_path / "spool"), "big",
                  {"paths": [os.path.basename(p) for p in paths]})
    deadline = time.time() + WAIT_S
    while len(_done_lines(jpath)) < 2:
        assert time.time() < deadline, "no per-archive progress journaled"
        assert proc.poll() is None
        time.sleep(0.05)
    os.kill(proc.pid, signal.SIGKILL)
    assert proc.wait(timeout=WAIT_S) == -signal.SIGKILL
    assert len(_done_lines(jpath)) == 2
    proc2, out2, _port = _start_daemon(tmp_path)
    assert _wait_state(jpath, "big", proc2) == "done"
    proc2.send_signal(signal.SIGTERM)
    assert proc2.wait(timeout=WAIT_S) == 0
    done = _done_lines(jpath)
    assert len(done) == 4 and len(set(done)) == 4
    state = FleetJournal(jpath).request_states()["big"]
    assert (state["n_skipped"], state["n_cleaned"]) == (2, 2)
    assert "serve: recovered 1 journaled request" in open(out2).read()
    for p in paths:
        np.testing.assert_array_equal(
            load_archive(p + "_cleaned.icar").weights,
            clean_archive(load_archive(p), CFG).final_weights.astype(
                np.float32))


def test_serve_sigterm_drains_and_a_second_signal_forces_exit(tmp_path):
    """SIGTERM while a request runs: it finishes and journals, a
    mid-drain spool file stays for the next start, exit 0.  A daemon
    wedged in an execute hang: the second signal force-exits 70 and
    dumps the flight recorder."""
    paths = _write(tmp_path, [(6, 12, 32)] * 2, ext=".icar")
    jpath = str(tmp_path / "serve.journal.jsonl")
    spool = str(tmp_path / "spool")
    proc, out, _port = _start_daemon(tmp_path)
    _spool_submit(spool, "work", {"paths": [os.path.basename(p)
                                            for p in paths]})
    deadline = time.time() + WAIT_S
    while '"state": "running"' not in (open(jpath).read()
                                       if os.path.exists(jpath) else ""):
        assert time.time() < deadline and proc.poll() is None
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    _spool_submit(spool, "mid_drain", {"paths": ["whatever.icar"]})
    assert proc.wait(timeout=WAIT_S) == 0
    assert FleetJournal(jpath).request_states()["work"]["state"] == "done"
    assert "mid_drain.json" in os.listdir(spool)
    assert "drained" in open(out).read()

    from iterative_cleaner_torch.serve.daemon import FORCE_EXIT_CODE

    os.remove(os.path.join(spool, "mid_drain.json"))
    proc, out, _port = _start_daemon(
        tmp_path, ["--faults", "execute:hang@1", "--journal", "j2.jsonl",
                   "--flight-recorder", "box.json"],
        ICLEAN_FAULT_HANG_S="600")
    _spool_submit(spool, "stuck", {"paths": [os.path.basename(paths[0])]})
    deadline = time.time() + WAIT_S
    j2 = str(tmp_path / "j2.jsonl")
    while '"state": "running"' not in (open(j2).read()
                                       if os.path.exists(j2) else ""):
        assert time.time() < deadline and proc.poll() is None
        time.sleep(0.02)
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    time.sleep(0.5)
    assert proc.poll() is None          # the drain waits on the hang
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=WAIT_S) == FORCE_EXIT_CODE
    with open(tmp_path / "box.json") as f:
        box = json.load(f)
    assert box["reason"] == "force-exit" and box["threads"]


# ------------------------------------------------------- the elastic pool

def test_shard_owner_is_the_references():
    from iterative_cleaner_tpu.parallel.distributed import (
        shard_owner as ref_shard_owner,
    )
    from iterative_cleaner_torch.parallel.distributed import shard_owner

    members = ["m1-aa", "m2-bb", "m3-cc"]
    for key in ("req-%d" % i for i in range(40)):
        assert shard_owner(key, members) == ref_shard_owner(key, members)
    assert shard_owner("x", []) is None


def test_pool_membership_and_adoption(tmp_path):
    """Two pool members over one journal: each sees the other live; a
    request one member accepted (its worker not running) is taken and run
    by the other, bit-equal to the port's ``clean_archive``; a member
    whose heartbeat lapsed is evicted once."""
    from iterative_cleaner_torch.serve import PoolMembership

    jpath = str(tmp_path / "pool.jsonl")
    (path,) = _write(tmp_path, [(6, 12, 32)])
    a = _daemon(tmp_path, journal_path=jpath, join=True, member_ttl_s=3.0,
                flight_recorder="")
    a.membership.join()
    a.admit(parse_request({"paths": [path], "id": "shared"},
                          base_config=CFG), source="http")
    b = _daemon(tmp_path, journal_path=jpath, join=True, member_ttl_s=3.0,
                flight_recorder="")
    t, url = _start(b)
    try:
        state = _wait_done(url, "shared")
        assert state["state"] == "done"
        # a live member's accepted request without an execution lease is
        # any member's to run: the second takes it at its start
        assert b.registry.counters["serve_recovered"] == 1
        assert b.registry.counters["serve_completed"] == 1
        assert len(b.membership.live_members()) == 2
    finally:
        _stop(b, t)
    np.testing.assert_array_equal(
        load_archive(path + "_cleaned.npz").weights,
        clean_archive(load_archive(path), CFG).final_weights.astype(
            np.float32))
    watcher = PoolMembership(FleetJournal(jpath), ttl_s=3.0)
    watcher.join()
    assert watcher.evict_lapsed() == []
    later = time.time() + 10.0
    assert watcher.evict_lapsed(now=later) == [a.membership.member_id]
    assert watcher.evict_lapsed(now=later) == []


def _chunks(tmp_path, name, seed, nsub=4):
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=16, nbin=32, seed=seed)
    d = tmp_path / name
    d.mkdir()
    paths = []
    for i, tile in enumerate(ar.total_intensity()):
        paths.append(str(d / ("%03d.npy" % i)))
        np.save(paths[-1], tile)
    return ar, paths


def _solo_close(ar, cfg):
    solo = OnlineSession(StreamMeta.from_archive(ar), cfg)
    for tile in ar.total_intensity():
        solo.ingest(tile)
    return solo.close()


def test_daemon_mux_streams_bit_equal_to_solo_sessions(tmp_path):
    """Bare ``--mux``: two concurrent stream requests share the daemon's
    StreamMux; each close is a solo session's, bit for bit, and
    ``/healthz`` reports the mux."""
    cfg = dataclasses.replace(CFG, stream_reconcile_every=2)
    streams = {k: _chunks(tmp_path, k, seed) for k, seed in (("s0", 3),
                                                             ("s1", 4))}
    d = _daemon(tmp_path, base=cfg, mux=True, mux_max_batch=2,
                mux_max_wait_ms=1.0)
    t, url = _start(d)
    try:
        for key, (ar, _paths) in streams.items():
            _post(url + "/submit", {"id": key, "kind": "stream",
                                    "meta": StreamMeta.from_archive(
                                        ar).to_dict()})
        for i in range(4):
            for key, (_ar, paths) in streams.items():
                _post(url + "/stream/%s/subint" % key, {"path": paths[i],
                                                        "seq": i})
        assert _get(url + "/healthz")["mux"]["streams"] == 2
        for key in streams:
            _post(url + "/stream/%s/close" % key, {})
        states = {key: _wait_done(url, key) for key in streams}
    finally:
        _stop(d, t)
    for key, (ar, _paths) in streams.items():
        assert states[key]["state"] == "done"
        np.testing.assert_array_equal(
            load_archive(states[key]["out"]).weights,
            _solo_close(ar, cfg).archive.weights)


def test_daemon_restart_replays_an_open_stream(tmp_path):
    """A stream left open by a stopped daemon (its chunks journaled) is
    replayed into a fresh session by the next daemon on the journal, a
    re-POST of a journaled seq answers duplicate, and its close is the
    solo session's of all its subints."""
    ar, paths = _chunks(tmp_path, "live", 5, nsub=5)
    meta = StreamMeta.from_archive(ar).to_dict()
    first = _daemon(tmp_path)
    t, url = _start(first)
    try:
        _post(url + "/submit", {"id": "live", "kind": "stream",
                                "meta": meta})
        for i in range(3):
            _post(url + "/stream/live/subint", {"path": paths[i], "seq": i})
    finally:
        _stop(first, t)
    second = _daemon(tmp_path)
    t, url = _start(second)
    try:
        assert second.registry.counters["online_replayed_subints"] == 3
        assert _post(url + "/stream/live/subint",
                     {"path": paths[2], "seq": 2})["duplicate"]
        for i in range(3, 5):
            _post(url + "/stream/live/subint", {"path": paths[i], "seq": i})
        _post(url + "/stream/live/close", {})
        state = _wait_done(url, "live")
    finally:
        _stop(second, t)
    assert state["state"] == "done" and state["n_subints"] == 5
    np.testing.assert_array_equal(load_archive(state["out"]).weights,
                                  _solo_close(ar, CFG).archive.weights)
