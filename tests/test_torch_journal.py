"""The port's fleet journal (``resilience/journal.py``,
``resilience/segmented.py``) against the JAX package's: the segmented
backend's crash matrix, fold equivalence, manifest and orphan semantics
and telemetry (as ``tests/test_segmented_journal.py``), plus the
cross-package reads in both directions (one line format, one version),
the torn tail each package leaves for the other, and the stale reading
of a reference ``done`` line: the packages' config hashes differ (the
port's identity holds ``device``), so a reference journal never makes
the port skip an archive.

Not mirrored: the reference's ``--journal-fsck`` checker and its
``PoolMembership`` (ROADMAP item 8); the maintenance lease is held here
as the claim it is."""

import json
import os
import re

import numpy as np
import pytest

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.resilience.journal import (
    FleetJournal as RefJournal,
)
from iterative_cleaner_tpu.utils.checkpoint import (
    config_hash as ref_config_hash,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.parallel.distributed import stable_shard
from iterative_cleaner_torch.resilience import (
    FleetJournal,
    ResiliencePlan,
    RetryPolicy,
    entry_key,
)
from iterative_cleaner_torch.resilience.segmented import (
    MANIFEST_NAME,
    compacted_name,
)
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_torch.utils.checkpoint import config_hash

CFG = "cfg-seg-test"
# lease timestamps far in the future, so mid-workload compactions (which
# age out lapsed leases against the wall clock) are fold-neutral
T0 = 4.0e9


def _seg_dir(tmp_path, name="journal.d", cls=FleetJournal, **kwargs):
    kwargs.setdefault("segment_mb", 0.0008)   # ~800 B: seals constantly
    return cls(str(tmp_path / name) + os.sep, **kwargs)


def _make(kind, tmp_path, name, cls=FleetJournal, **kwargs):
    if kind == "segmented":
        return _seg_dir(tmp_path, name + ".d", cls=cls, **kwargs)
    return cls(str(tmp_path / (name + ".jsonl")), **kwargs)


def _write_pair(tmp_path):
    a = tmp_path / "in.icar"
    b = tmp_path / "out.icar"
    a.write_bytes(b"input-bytes")
    b.write_bytes(b"output-bytes")
    return str(a), str(b)


def _workload_ops(a, b):
    """A deterministic op tape over all six event kinds, with seals and
    compactions interleaved (the reference test's tape)."""
    ops = []
    for i in range(6):
        ops.append(("req", lambda j, i=i: j.record_request(
            "r%03d" % i, "accepted", paths=["/in/%d" % i])))
        ops.append(("claim", lambda j, i=i: j.record_claim(
            "bucket-%d" % i, host=i % 3, nonce="n%d" % i, ttl_s=60.0,
            now=T0 + i)))
    ops.append(("seal", lambda j: j.seal()))
    for i in range(3):
        ops.append(("member", lambda j, i=i: j.record_member(
            "m%d" % i, "join", host=i, ttl_s=60.0, now=T0 + i)))
        ops.append(("stats", lambda j, i=i: j.record_host_stats(
            i, {"cleaned": float(i)})))
    ops.append(("done", lambda j: j.record_done(
        a, config_hash=CFG, out_path=b)))
    ops.append(("cache", lambda j: j.record_cache(
        a, config_hash=CFG, out_path=b)))
    ops.append(("compact", lambda j: j.compact()))
    for i in range(6):
        ops.append(("req", lambda j, i=i: j.record_request(
            "r%03d" % i, "done")))
        ops.append(("claim", lambda j, i=i: j.record_claim(
            "bucket-%d" % i, host=i % 3, nonce="n%d" % i, ttl_s=0.0,
            state="release", now=T0 + 200.0 + i)))
    ops.append(("seal", lambda j: j.seal()))
    ops.append(("compact", lambda j: j.compact()))
    for i in range(3):
        ops.append(("req", lambda j, i=i: j.record_request(
            "s%d" % i, "accepted", paths=["/late/%d" % i])))
    return ops


def _folds(j, now=T0 + 30.0):
    return {
        "requests": j.request_states(),
        "claims": j.claim_table(now=now),
        "members": j.member_table(now=now),
        "stats": j.host_stats(),
        "completed": j.completed(CFG),
        "cache": j.cache_index(),
    }


class _Boom(RuntimeError):
    """The injected crash (not an OSError: no heal path may swallow it)."""


def _run_ops(j, ops, crash_at=None):
    """Run the op tape with ``os.replace`` counted and crashed at call
    ``crash_at``: (ops that put a line on disk, replace calls, crashed)."""
    real = os.replace
    calls = {"n": 0}

    def patched(src, dst, *args, **kwargs):
        calls["n"] += 1
        if crash_at is not None and calls["n"] == crash_at:
            raise _Boom("injected at os.replace #%d" % calls["n"])
        return real(src, dst, *args, **kwargs)

    durable = []
    crashed = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "replace", patched)
        try:
            for kind, fn in ops:
                if kind not in ("seal", "compact"):
                    durable.append((kind, fn))
                fn(j)
        except _Boom:
            crashed = True
    return durable, calls["n"], crashed


# ---- the segmented backend ----------------------------------------------

def test_crash_matrix_every_replace_boundary(tmp_path):
    """A crash at every ``os.replace`` of a seal/compact workload leaves a
    directory whose cold reopen folds as a journal that never crashed."""
    a, b = _write_pair(tmp_path)
    ops = _workload_ops(a, b)
    dry = _seg_dir(tmp_path, "dry.d")
    _, n_boundaries, crashed = _run_ops(dry, ops)
    assert not crashed and n_boundaries >= 15
    for k in range(1, n_boundaries + 1):
        root = tmp_path / ("crash-%03d" % k)
        root.mkdir()
        j = _seg_dir(root)
        durable, _, crashed = _run_ops(j, ops, crash_at=k)
        assert crashed, f"boundary {k}: workload outran the dry run"
        ref = FleetJournal(str(root / "ref.jsonl"))
        for _, fn in durable:
            fn(ref)
        j2 = FleetJournal(str(root / "journal.d"))   # cold reopen
        assert j2.backend == "segmented"
        assert _folds(j2) == _folds(ref), f"boundary {k}: folds diverge"
        j2.seal()
        j2.compact()
        ref.compact()
        assert _folds(j2) == _folds(ref), \
            f"boundary {k}: post-recovery compaction changed folds"


@pytest.mark.parametrize("cls", [FleetJournal, RefJournal],
                         ids=["port", "reference"])
def test_fold_equivalence_file_vs_segmented(tmp_path, cls):
    """One op tape folds identically through both backends, before and
    after compaction — and through either package's journal."""
    a, b = _write_pair(tmp_path)
    ops = _workload_ops(a, b)
    jf = FleetJournal(str(tmp_path / "ref.jsonl"))
    js = _seg_dir(tmp_path, cls=cls)
    for _, fn in ops:
        fn(jf)
        fn(js)
    assert _folds(js) == _folds(jf)
    assert js.seal() >= 0 and js.compact()
    assert jf.compact()
    assert _folds(js) == _folds(jf)


def test_manifest_n_shards_persists_across_reopen(tmp_path):
    j = _seg_dir(tmp_path, n_shards=4)
    for i in range(10):
        j.record_request("r%d" % i, "accepted")
    j2 = FleetJournal(j.path, n_shards=16)   # the constructor loses
    assert j2.n_shards() == 4
    assert len(j2.request_states()) == 10


def test_sealed_orphan_is_adopted_and_seq_stays_monotone(tmp_path):
    j = _seg_dir(tmp_path)
    j.record_request("orphan-req", "accepted")
    assert j.seal() == 1
    man_path = os.path.join(j.path, MANIFEST_NAME)
    man = json.loads(open(man_path).read())
    (shard_key, ent), = [(k, v) for k, v in man["shards"].items()
                         if v["segments"]]
    (orphan_name,) = ent["segments"]
    ent["segments"] = []                      # the crashed seal
    with open(man_path, "w") as f:
        json.dump(man, f)
    j2 = FleetJournal(j.path)
    assert j2.request_states()["orphan-req"]["state"] == "accepted"
    j2.record_request("orphan-req", "running")
    assert j2.seal() == 1
    seq_of = lambda n: int(re.search(r"-(\d+)\.jsonl$", n).group(1))
    names = [n for n in os.listdir(j2.path)
             if n.startswith("seg-%02d" % int(shard_key))]
    assert orphan_name in names
    assert max(seq_of(n) for n in names) > seq_of(orphan_name)
    assert j2.request_states()["orphan-req"]["state"] == "running"


def test_compacted_orphan_is_never_adopted(tmp_path):
    j = _seg_dir(tmp_path)
    j.record_request("real", "accepted")
    shard = stable_shard("req:ghost", j.n_shards())
    ghost = {"schema": "icln-fleet-journal/1", "event": "req",
             "req": "ghost", "state": "accepted"}
    with open(os.path.join(j.path, compacted_name(shard, 99)), "w") as f:
        f.write(json.dumps(ghost) + "\n")
    states = FleetJournal(j.path).request_states()
    assert "real" in states and "ghost" not in states


def test_dead_listed_file_is_excluded_then_gced(tmp_path):
    j = _seg_dir(tmp_path)
    j.record_request("keep", "accepted")
    shard = stable_shard("req:keep", j.n_shards())
    assert j.seal() == 1
    man_path = os.path.join(j.path, MANIFEST_NAME)
    man = json.loads(open(man_path).read())
    ent = man["shards"][str(shard)]
    (seg,) = ent["segments"]
    cmp_name = compacted_name(shard, 1)
    with open(os.path.join(j.path, cmp_name), "w") as f:
        f.write(json.dumps({"schema": "icln-fleet-journal/1",
                            "event": "req", "req": "keep",
                            "state": "done"}) + "\n")
    ent["segments"] = [cmp_name]
    ent["dead"] = [seg]
    with open(man_path, "w") as f:
        json.dump(man, f)
    j2 = FleetJournal(j.path)
    assert j2.request_states()["keep"]["state"] == "done"
    j2.compact()                              # drives _gc_dead
    assert not os.path.exists(os.path.join(j2.path, seg))
    man = json.loads(open(man_path).read())
    assert man["shards"][str(shard)]["dead"] == []
    assert j2.request_states()["keep"]["state"] == "done"


@pytest.mark.parametrize("kind", ["file", "segmented"])
def test_torn_tail_heal_counts(tmp_path, kind):
    """A torn tail is healed on the next append and counted
    (``journal_torn_heals``), never silent."""
    reg = MetricsRegistry()
    j = _make(kind, tmp_path, "j", registry=reg)
    j.record_request("t1", "accepted")
    victim = (j.log._active_path(stable_shard("req:t1", j.n_shards()))
              if j.backend == "segmented" else j.path)
    with open(victim, "rb+") as f:
        f.truncate(os.path.getsize(victim) - 3)
    j.record_request("t1", "running")
    assert reg.snapshot()["counters"]["journal_torn_heals"] == 1
    assert j.request_states()["t1"]["state"] == "running"


@pytest.mark.parametrize("kind", ["file", "segmented"])
def test_fold_timer_and_compaction_counter(tmp_path, kind):
    reg = MetricsRegistry()
    j = _make(kind, tmp_path, "j", registry=reg)
    for i in range(5):
        j.record_request("r%d" % i, "accepted")
    j.request_states()
    assert reg.snapshot()["histograms"]["journal_fold_s"]["count"] >= 1
    j.seal()
    assert j.compact()
    assert reg.snapshot()["counters"]["journal_compactions"] == 1


def test_segment_counts_and_size_bytes(tmp_path):
    j = _seg_dir(tmp_path, segment_mb=0.0001)   # 100 B: seal every line
    for i in range(12):
        j.record_request("r%d" % i, "accepted", paths=["/x/%d" % i])
    counts = j.segment_counts()
    assert sum(counts.values()) >= 2
    assert set(counts) == set(range(j.n_shards()))
    assert j.size_bytes() > 0
    assert j.seal() >= 0 and j.compact()
    assert sum(j.segment_counts().values()) <= sum(counts.values())
    assert len(j.request_states()) == 12


@pytest.mark.parametrize("kind", ["file", "segmented"])
def test_claim_lease_is_exclusive(tmp_path, kind):
    """Two claimants race for one work item: exactly one wins, a release
    hands it over, an expired lease is stealable, a heartbeat never
    steals, and distinct items are independent."""
    j = _make(kind, tmp_path, "j")
    assert j.try_claim("maint:3", host=1, nonce="m1", ttl_s=30.0, now=100.0)
    assert not j.try_claim("maint:3", host=2, nonce="m2", ttl_s=30.0,
                           now=101.0)
    j.heartbeat("maint:3", host=2, nonce="m2", ttl_s=30.0, now=102.0)
    assert j.claim_table(now=102.0)["maint:3"]["nonce"] == "m1"
    j.release("maint:3", host=1, nonce="m1", now=103.0)
    assert j.try_claim("maint:3", host=2, nonce="m2", ttl_s=30.0, now=104.0)
    assert j.try_claim("maint:4", host=1, nonce="m1", ttl_s=30.0, now=104.0)
    # m2's lease expires at 134: a claim at 200 steals it
    assert not j.claim_table(now=200.0)["maint:3"]["live"]
    assert j.try_claim("maint:3", host=1, nonce="m3", ttl_s=30.0, now=200.0)


def test_entry_key_and_stable_shard_match_the_reference():
    """Both packages route a line to the same shard: one key, one hash."""
    from iterative_cleaner_tpu.parallel.distributed import (
        stable_shard as ref_shard,
    )
    from iterative_cleaner_tpu.resilience.journal import (
        entry_key as ref_key,
    )

    entries = [{"event": "done", "path": "/a"}, {"event": "req", "req": "r"},
               {"event": "claim", "work": "bucket:1x2x3:0"},
               {"event": "member", "member": "m"}, {"event": "stats",
                                                    "host": 3},
               {"event": "cache", "key": "k"}, {"event": "other"}]
    for e in entries:
        assert entry_key(e) == ref_key(e)
        for n in (1, 2, 7, 8, 64):
            assert stable_shard(entry_key(e), n) == ref_shard(ref_key(e), n)


# ---- across the packages ------------------------------------------------

@pytest.mark.parametrize("kind", ["file", "segmented"])
@pytest.mark.parametrize("writer,reader", [
    (FleetJournal, RefJournal), (RefJournal, FleetJournal)],
    ids=["port_to_reference", "reference_to_port"])
def test_each_package_reads_the_others_journal(tmp_path, kind, writer,
                                               reader):
    """A journal one package wrote folds identically in the other, with a
    torn tail the writer left (a writer killed mid-line), and the reader
    can append after it (healing the tail)."""
    a, b = _write_pair(tmp_path)
    w = _make(kind, tmp_path, "x", cls=writer)
    for _, fn in _workload_ops(a, b):
        fn(w)
    w.record_request("torn", "accepted")
    victim = (w.log._active_path(stable_shard("req:torn", w.n_shards()))
              if w.backend == "segmented" else w.path)
    with open(victim, "rb+") as f:
        f.truncate(os.path.getsize(victim) - 5)
    r = reader(w.path)
    assert r.backend == w.backend
    want = _folds(FleetJournal(w.path))
    assert _folds(r) == want
    assert "torn" not in r.request_states()
    r.record_request("after", "accepted")
    for j in (FleetJournal(w.path), RefJournal(w.path)):
        assert j.request_states()["after"]["state"] == "accepted"
        assert "r000" in j.request_states()


def test_reference_done_line_is_stale_in_the_port(tmp_path):
    """A ``done`` line the reference wrote under its config hash never
    satisfies the port's resume: the port cleans the archive again."""
    from iterative_cleaner_torch.parallel.fleet import clean_fleet

    ar, _ = make_synthetic_archive(nsub=6, nchan=16, nbin=32, seed=40)
    path = str(tmp_path / "a.npz")
    save_archive(ar, path)
    jpath = str(tmp_path / "j.jsonl")
    ref_cfg = RefConfig(rotation="roll", dtype="float32", max_iter=3)
    cfg = CleanConfig(device="cpu", rotation="roll", max_iter=3)
    RefJournal(jpath).record_done(path, config_hash=ref_config_hash(ref_cfg))
    assert ref_config_hash(ref_cfg) != config_hash(cfg)
    assert FleetJournal(jpath).completed(config_hash(cfg)) == {}
    assert os.path.abspath(path) in FleetJournal(jpath).completed(
        ref_config_hash(ref_cfg))
    rep = clean_fleet([path], cfg, resilience=ResiliencePlan(
        retry=RetryPolicy(max_retries=0), journal=FleetJournal(jpath),
        resume=True))
    assert rep.ok and rep.skipped == [] and list(rep.results) == [path]
    # and a done line of the port's own hash is trusted
    FleetJournal(jpath).record_done(path, config_hash=config_hash(cfg))
    rep2 = clean_fleet([path], cfg, resilience=ResiliencePlan(
        journal=FleetJournal(jpath), resume=True))
    assert rep2.skipped == [path] and rep2.results == {}
    assert np.asarray(rep.results[path].final_weights).shape == (6, 16)
