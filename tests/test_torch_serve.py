"""The port's resident fleet service (librabft_simulator_tpu_torch/serve/
service.py, api.py, cli.py) and its host egress (distributed/egress.py) on
the CPU, bit for bit:

(a) one served session (the micro serial shape with the scenario,
    adversary, watchdog and telemetry planes; SERVE_SLOTS slots, six
    requests, so two wait for slots that egress freed): every result equals
    its dedicated static run (``ScenarioSpec.to_params`` with its masks and
    program), and the landed row of every request equals that run in every
    leaf but ``sc_*``, so no admission disturbed a live slot; two attacked
    requests equal ``OracleSim(attack=)``; the service's host reads,
    counted through its one seam (``service._host_read``), are one digest
    per polled chunk, and the halted plane only where the digest said an
    active slot halted;
(b) (a)'s checkpoint after two chunks (``FleetService.preempt``), resumed
    under the device-wrap ring (the other pump) and drained: every result
    equals (a)'s, ``poll`` answers for the ids egressed before the
    preemption, a new submission skips the restored ids, and the ring is
    read once per outer call;
(c) admission: at each of (a)'s later waves the live slots and the
    admitted ones land equal to their dedicated runs (each slot's
    undisturbed trajectory) in every leaf; a batched wave (``plane_rows``,
    one ``init_rows``) equals JAX's ``plane_row`` row by row and per-slot
    ``init_slot``; ``install_at`` equals ``install_rows`` with a
    fleet-shaped donor;
(d) JAX's host code on the same inputs: ``load_requests`` (results and
    error texts), ``ScenarioSpec.to_dict``, ``serve.cli``'s flags against
    ``scripts/fleet_serve.py``'s parser, and the egress host functions on a
    one-device JAX CPU mesh (no executable: JAX states are shaped by
    ``eval_shape``, row gathers read numpy-backed shards);
(e) one serve on the lane engine, each landed row equal to a static lane
    fleet run's.

No JAX executable is built here.  The referee against JAX's own
``ResidentFleet`` is slow-marked:

    python -m pytest tests/test_torch_serve.py -m slow -p no:xdist
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import types

import jax
import numpy as np
import pytest

from fleet_shapes import (ADV_WINDOWS, FLEET_RING_K, FLEET_SCENARIO_LANE_KW,
                          FLEET_SCENARIO_SER_KW, FLEET_SER_KW, FLEET_WD_STALL,
                          SERVE_CHUNK, SERVE_SLOTS)
from librabft_simulator_tpu.core.types import SimParams as JParams
from librabft_simulator_tpu.distributed import egress as jegress
from librabft_simulator_tpu.oracle.sim import OracleSim
from librabft_simulator_tpu.serve import api as japi
from librabft_simulator_tpu.serve import scenario as jsc
from librabft_simulator_tpu.sim import simulator as JS
from tests.port_support import import_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The serve shape: the micro serial shape with the scenario plane, plus the
#: adversary plane and the watchdog (telemetry is on in it already), so the
#: results carry every optional key.
SERVE_KW = dict(FLEET_SCENARIO_SER_KW, adversary=True, adv_windows=ADV_WINDOWS,
                watchdog=True, watchdog_stall_events=FLEET_WD_STALL, max_clock=120)
#: Six requests for four slots: the short one halts first, and the last two
#: go into slots that egress freed.  Delay families, both chains (each
#: commits), a drop rate, a static schedule and three attack programs.
REQUESTS = [
    dict(seed=11),
    dict(commit_chain=2, max_clock=100, seed=22,
         attack={"windows": [{"behavior": "equivocate", "start": 10, "end": 80,
                              "targets": [2]}]}),
    dict(max_clock=40, seed=55),
    dict(delay_kind="pareto", delay_pareto_scale=2.0, delay_pareto_alpha=2.5,
         drop_prob=0.05, max_clock=100, seed=33,
         attack={"partition": {"groups": [[0], [1, 2]], "heal": 50}}),
    dict(byz_kind="silent", byz_f=1, commit_chain=2, max_clock=70, seed=44),
    dict(delay_kind="uniform", max_clock=90, seed=66,
         attack={"windows": [{"behavior": "forge_qc", "start": 0, "end": 60,
                              "targets": [0]}]}),
]
ORACLE_REQUESTS = (1, 5)
PREEMPT_CHUNKS = 2
WALL_CLOCK = ("ttfc_s",)


@pytest.fixture(scope="module", autouse=True)
def _import_port():
    """torch and the port, imported when a test of this file first runs."""
    global torch, convert, SimParams, S, P, sc, service, api, cli, egress, M, ledger
    torch = import_torch()
    from librabft_simulator_tpu_torch import convert
    from librabft_simulator_tpu_torch.core.types import SimParams
    from librabft_simulator_tpu_torch.distributed import egress
    from librabft_simulator_tpu_torch.parallel import mesh as M
    from librabft_simulator_tpu_torch.serve import api, cli, scenario as sc, service
    from librabft_simulator_tpu_torch.sim import parallel_sim as P
    from librabft_simulator_tpu_torch.sim import simulator as S
    from librabft_simulator_tpu_torch.telemetry import ledger


def base():
    return SimParams(**SERVE_KW)


def specs():
    return [sc.ScenarioSpec(**dict(dict(max_clock=SERVE_KW["max_clock"]), **r))
            for r in REQUESTS]


def assert_leaves_equal(got, want, skip=("sc_",)):
    assert list(got) == list(want)
    for k in want:
        if k.startswith(skip):
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def dedicated(p, spec, engine=None):
    """A spec's dedicated static run on the CPU: its params, static masks
    and program installed (serial engine unless ``engine``)."""
    eng = engine or S
    pi = spec.to_params(p)
    eq, silent, forge = spec.byz_masks(p)
    st = eng.init_batch(pi, [spec.seed], byz_equivocate=eq, byz_silent=silent,
                        byz_forge_qc=forge, device="cpu")
    prog = spec.attack_program()
    if prog is not None:
        st = prog.install(pi, st)
    # Halted instances are exact no-ops: a short serial chunk stops soon
    # after the halt, and the final state does not depend on it.
    kw = {"chunk": 16} if eng is S else {}
    return convert.to_reference(eng.run_to_completion(pi, st, **kw))


class Reads:
    """The service's host reads, counted through ``service._host_read``;
    the rows landed at each egress are kept per request id."""

    def __init__(self, mp, fleet_of):
        self.counts, self.rows, self.egress_calls = {}, {}, []
        real = service._host_read

        def spy(kind, fn, *args):
            self.counts[kind] = self.counts.get(kind, 0) + 1
            out = real(kind, fn, *args)
            if kind == "rows":
                fleet = fleet_of()
                held, rows = out
                ref = convert.to_reference(rows)
                for j, slot in enumerate(held):
                    rid = fleet._active[slot].request_id
                    self.rows[rid] = {k: v[j:j + 1] for k, v in ref.items()}
                self.egress_calls.append(len(held))
            return out

        mp.setattr(service, "_host_read", spy)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(a)'s session, through FleetService and an NDJSON request file: served
    for PREEMPT_CHUNKS chunks, checkpointed (``preempt``; (b) resumes it),
    then drained on.  The results, the reads, the stream rows, the fleet,
    the checkpoint and what it held."""
    d = tmp_path_factory.mktemp("serve")
    reqs = d / "requests.ndjson"
    reqs.write_text("".join(json.dumps(dict(s.to_dict(), id=f"r{i}")) + "\n"
                            for i, s in enumerate(specs())))
    holder = {}
    with pytest.MonkeyPatch.context() as mp:
        reads = Reads(mp, lambda: holder["fleet"])
        svc = api.FleetService(base(), slots=SERVE_SLOTS, chunk=SERVE_CHUNK, device="cpu",
                               out=str(d / "serve.ndjson"))
        fleet = holder["fleet"] = svc.fleet
        ids = svc.submit_file(str(reqs))
        svc.serve(max_chunks=PREEMPT_CHUNKS)
        ckpt = str(d / "svc.npz")
        svc.preempt(ckpt)
        at_preempt = dict(fleet.results)
        results = svc.drain()
        svc.close()
    stream = [json.loads(ln) for ln in (d / "serve.ndjson").read_text().splitlines()]
    return dict(ids=ids, results=results, reads=reads, stream=stream, fleet=fleet,
                ckpt=ckpt, at_preempt=at_preempt)


@pytest.fixture(scope="module")
def references():
    p = base()
    return [dedicated(p, s) for s in specs()]


def result_fields(ref, i=0):
    return dict(events=int(ref["n_events"][i]), clock=int(ref["clock"][i]),
                commits=[int(c) for c in ref["ctx.commit_count"][i]],
                committed_round_max=int(ref["store.hcr"][i].max()),
                msgs_sent=int(ref["n_msgs_sent"][i]),
                msgs_dropped=int(ref["n_msgs_dropped"][i]))


# ---------------------------------------------------------------------------
# (a) one served session.
# ---------------------------------------------------------------------------


def test_served_results_equal_dedicated_runs(served, references):
    p, res = base(), served["results"]
    assert set(res) == set(served["ids"])
    assert [res[i]["slot"] for i in served["ids"]][:SERVE_SLOTS] == list(range(SERVE_SLOTS))
    jp = JParams(**SERVE_KW)
    for rid, spec, ref in zip(served["ids"], specs(), references):
        r = res[rid]
        want_keys = ["request_id", "spec", "slot", "events", "clock", "commits",
                     "committed_round_max", "msgs_sent", "msgs_dropped", "safe",
                     "ttfc_s", "watchdog"] + (["attack"] if spec.attack else []) + ["telemetry"]
        assert list(r) == want_keys
        assert r["request_id"] == rid and r["spec"] == spec.to_dict()
        assert {k: r[k] for k in result_fields(ref)} == result_fields(ref)
        assert r["safe"] is True and r["ttfc_s"] is not None and r["ttfc_s"] >= 0
        # Every leaf of the landed row but the plane rows equals the
        # dedicated run: no admission or egress disturbed it.
        assert_leaves_equal(served["reads"].rows[rid], ref)
        wd = ref["wd"][0]
        assert r["watchdog"]["stall"] == int(wd[1]) and r["watchdog"]["safety_ok"]
        if spec.attack:
            jspec = jsc.ScenarioSpec.from_dict(spec.to_dict())
            assert r["attack"] == jspec.attack_program().host_plane(jp).describe()
        tel = r["telemetry"]
        assert sum(tel[k] for k in ("ev_notify", "ev_request", "ev_response",
                                    "ev_timer")) == r["events"]
        assert tel["drops"] == r["msgs_dropped"]
    assert {res[i]["spec"]["commit_chain"] for i in served["ids"]
            if max(res[i]["commits"]) > 0} == {2, 3}


def test_attacked_results_equal_the_oracle(served):
    p = base()
    jp = JParams(**SERVE_KW)
    for i in ORACLE_REQUESTS:
        spec = specs()[i]
        r = served["results"][served["ids"][i]]
        jspec = jsc.ScenarioSpec.from_dict(spec.to_dict())
        eq, silent, forge = (np.asarray(m) for m in spec.byz_masks(p))
        orc = OracleSim(jspec.to_params(jp), spec.seed, byz_equivocate=list(eq),
                        byz_silent=list(silent), byz_forge_qc=list(forge),
                        attack=spec.attack).run()
        assert (r["events"], r["clock"], r["msgs_sent"], r["msgs_dropped"]) == (
            orc.n_events, orc.clock, orc.n_msgs_sent, orc.n_msgs_dropped)
        assert r["commits"] == [orc.ctxs[a].commit_count for a in range(p.n_nodes)]
        assert r["committed_round_max"] == max(s.hcr for s in orc.stores)


def test_host_reads_are_one_digest_per_chunk(served):
    fleet, reads = served["fleet"], served["reads"]
    counts = reads.counts
    assert counts["digest"] == fleet.chunks_polled > 0 and "ring" not in counts
    assert counts["state"] == 1   # the checkpoint (b) resumes
    # The halted plane is read only when the digest said an active slot
    # halted, and each such read found finished slots: the egress lands
    # exactly those rows, one batch per read.
    assert counts["halted"] == counts["rows"] == len(reads.egress_calls) >= 2
    assert all(k > 0 for k in reads.egress_calls)
    assert sum(reads.egress_calls) == len(REQUESTS)
    spans = [s for s in ledger.get().spans if s.attrs.get("run") == fleet._rid]
    assert sum(s.kind == ledger.EGRESS for s in spans) == counts["halted"]
    waves = [s.attrs["requests"] for s in spans if s.kind == ledger.ADMIT]
    assert waves[0] == SERVE_SLOTS and sum(waves) == len(REQUESTS)
    # The stream replays every request's lifecycle.
    events = [r for r in served["stream"] if r.get("kind") == "request"]
    for rid in served["ids"]:
        assert [e["event"] for e in events if e["id"] == rid] == [
            "submitted", "admitted", "first_chunk", "egressed"]
    egressed = {e["id"]: e for e in events if e["event"] == "egressed"}
    assert all(egressed[i]["result"] == served["results"][i] for i in served["ids"])
    meta = served["stream"][0]
    assert meta["kind"] == "meta" and meta["serve"] and meta["slots"] == SERVE_SLOTS


# ---------------------------------------------------------------------------
# (b) preempt, resume under the ring.
# ---------------------------------------------------------------------------


def test_preempt_resume_under_the_ring_changes_nothing(served):
    """(a)'s checkpoint, taken after PREEMPT_CHUNKS chunks of the host wrap,
    resumed under the device-wrap ring and drained: every result as (a)'s
    uninterrupted host-wrap drain gave it."""
    before = served["at_preempt"]
    ids = served["ids"]
    assert ids == [f"r{i}" for i in range(len(REQUESTS))]
    assert before and len(before) < len(ids)
    side = json.loads(pathlib.Path(served["ckpt"] + ".serve.json").read_text())
    assert list(side) == ["serve_version", "slots", "chunk", "ring_k", "chunks_polled",
                          "active", "pending", "results"]
    assert side["chunks_polled"] == PREEMPT_CHUNKS and side["ring_k"] is None
    assert side["slots"] == SERVE_SLOTS and side["chunk"] == SERVE_CHUNK
    assert len(side["active"]) + len(side["pending"]) + len(side["results"]) == len(ids)
    ring_p = dataclasses.replace(base(), wrap="device", ring_k=FLEET_RING_K)
    holder = {}
    with pytest.MonkeyPatch.context() as mp:
        reads = Reads(mp, lambda: holder["svc"].fleet)
        svc = holder["svc"] = api.FleetService.resume(served["ckpt"], ring_p, device="cpu")
        assert svc.fleet._ring_k == FLEET_RING_K
        assert svc.fleet.chunks_polled == PREEMPT_CHUNKS
        for rid in before:
            assert svc.poll(rid)["status"] == "egressed"
            assert svc.poll(rid)["result"] == json.loads(json.dumps(before[rid]))
        extra = svc.submit(specs()[2])
        assert extra == f"r{len(ids)}"   # the restored ids are skipped
        res = svc.drain()
        svc.close()
    outer = [s for s in ledger.get().spans
             if s.attrs.get("run") == svc.fleet._rid and s.kind == ledger.POLL]
    assert reads.counts["ring"] == len(outer) and "digest" not in reads.counts
    assert sum(s.attrs["retired"] for s in outer) == svc.fleet.chunks_polled - PREEMPT_CHUNKS
    want = json.loads(json.dumps(served["results"]))
    for rid in ids:
        got = json.loads(json.dumps(res[rid]))
        assert {k: v for k, v in got.items() if k not in WALL_CLOCK} == \
            {k: v for k, v in want[rid].items() if k not in WALL_CLOCK}, rid
    short = want[ids[2]]
    assert {k: res[extra][k] for k in ("events", "commits")} == \
        {k: short[k] for k in ("events", "commits")}


# ---------------------------------------------------------------------------
# (c) admission.
# ---------------------------------------------------------------------------


def test_admission_leaves_live_slots_bit_identical(served, references):
    """(a)'s later admission waves landed while other slots were live: each
    live slot's landed row equals its dedicated static run (its undisturbed
    trajectory) in every leaf but ``sc_*``, and so does each admitted
    slot's."""
    rows = [r for r in served["stream"] if r.get("kind") == "request"]
    t = {(r["id"], r["event"]): i for i, r in enumerate(rows)}
    # A wave's admitted rows are emitted one after another.
    waves = []
    for i in sorted(t[(rid, "admitted")] for rid in served["ids"]):
        if waves and waves[-1][-1] == i - 1:
            waves[-1].append(i)
        else:
            waves.append([i])
    assert [len(w) for w in waves][0] == SERVE_SLOTS and len(waves) >= 2
    for wave in waves[1:]:
        admitted = [rows[i]["id"] for i in wave]
        live = [rid for rid in served["ids"]
                if t[(rid, "admitted")] < wave[0] < t[(rid, "egressed")]]
        assert live, "no slot was live at this admission"
        for rid in live + admitted:
            assert_leaves_equal(served["reads"].rows[rid], references[served["ids"].index(rid)])


def test_batched_wave_equals_init_slot():
    """A wave's rows from one ``plane_rows`` + ``init_rows`` call equal
    per-slot ``plane_row`` + ``init_slot``, and ``install_at`` writes them
    as ``install_rows`` does with a fleet-shaped donor."""
    p = base()
    wave = specs() + [sc.ScenarioSpec(byz_kind="forge_qc", byz_f=1, seed=7)]
    rows = [s.plane_row(p) for s in wave]
    plane = sc.plane_rows(p, wave)   # the service's admission builds it so
    jp = JParams(**SERVE_KW)
    for i, spec in enumerate(wave):
        want = jsc.ScenarioSpec.from_dict(spec.to_dict()).plane_row(jp)
        for k in plane.__dataclass_fields__:
            got = getattr(plane, k)[i].numpy()
            got = got.view(np.uint32) if k in plane.U32 else got
            w = np.asarray(getattr(want, k))
            assert got.dtype == w.dtype and got.shape == w.shape, k
            np.testing.assert_array_equal(got, w, err_msg=f"{i} {k}")
    batched = convert.to_reference(sc.init_rows(p, plane, device="cpu"))
    for i, row in enumerate(rows):
        one = convert.to_reference(sc.init_slot(p, row, device="cpu"))
        assert_leaves_equal({k: v[i:i + 1] for k, v in batched.items()}, one, skip=())
    fleet = sc.init_specs(p, specs()[:4], device="cpu")
    new_rows = sc.init_rows(p, sc.plane_rows(p, wave[4:6]), device="cpu")
    donor = sc.init_rows(p, sc.plane_rows(p, [wave[0], wave[4], wave[2], wave[5]]), device="cpu")
    by_mask = sc.install_rows(M.rows_of(fleet, 0, 4, "cpu"), [False, True, False, True],
                              M.rows_of(donor, 0, 4, "cpu"))
    by_idx = sc.install_at(fleet, [1, 3], new_rows)
    assert_leaves_equal(convert.to_reference(by_idx), convert.to_reference(by_mask), skip=())
    flags = S.byz_rows(p, sc.stack_rows(rows)).tolist()
    assert [f[0] for f in flags] == [False, True, False, False, False, False, False]
    assert [f[1] for f in flags] == [False] * 5 + [True, True]


# ---------------------------------------------------------------------------
# (d) JAX's host code on the same inputs.
# ---------------------------------------------------------------------------


def test_load_requests_and_errors_match_jax(tmp_path):
    good = tmp_path / "req.ndjson"
    lines = ["# a comment", ""] + [json.dumps(dict(r, id=f"q{i}") if i % 2 else r)
                                   for i, r in enumerate(REQUESTS)]
    good.write_text("\n".join(lines) + "\n")
    got, want = api.load_requests(str(good)), japi.load_requests(str(good))
    assert [rid for rid, _ in got] == [rid for rid, _ in want] == \
        ["3", "q1", "5", "q3", "7", "q5"]
    assert [s.to_dict() for _, s in got] == [s.to_dict() for _, s in want]
    assert [s.to_dict() for _, s in got] == [jsc.ScenarioSpec(**r).to_dict() for r in REQUESTS]
    bad = {"json": '{"seed": 1}\n{"seed": \n', "object": "[1, 2]\n",
           "dup": '{"id": "a"}\n\n{"id": "a"}\n', "field": '{"delay_knid": "x"}\n',
           "schedule": '{"byz_kind": "omission"}\n', "chain": '{"commit_chain": 4}\n',
           "empty": "# nothing\n\n", "attack": '{"attack": {"windows": [{"behavior": "x"}]}}\n'}
    for name, text in bad.items():
        path = tmp_path / f"{name}.ndjson"
        path.write_text(text)
        errs = []
        for fn in (api.load_requests, japi.load_requests):
            with pytest.raises(ValueError) as e:
                fn(str(path))
            errs.append(str(e.value))
        assert errs[0] == errs[1], name
    with pytest.raises(OSError):
        api.load_requests(str(tmp_path / "missing.ndjson"))
    # The submit-time attack check refuses a program this fleet cannot run.
    fleet = service.ResidentFleet(base(), slots=2, chunk=SERVE_CHUNK, device="cpu")
    with pytest.raises(ValueError):
        fleet.submit(dict(attack={"windows": [{"behavior": "silent", "targets": [5]}]}))
    assert fleet.pending_count == 0
    plain = service.ResidentFleet(SimParams(**FLEET_SER_KW), slots=2, device="cpu")
    with pytest.raises(ValueError, match="adversary=False"):
        plain.submit(specs()[1])
    with pytest.raises(ValueError, match="duplicate request id"):
        plain.submit(specs()[0], request_id="x")
        plain.submit(specs()[0], request_id="x")


def fleet_serve_parser():
    """scripts/fleet_serve.py's parser, taken at its parse_args."""
    spec = importlib.util.spec_from_file_location("fleet_serve_script",
                                                  ROOT / "scripts" / "fleet_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    class Taken(Exception):
        pass

    def take(self, argv=None, namespace=None):
        seen["parser"] = self
        raise Taken

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = take
    try:
        with pytest.raises(Taken):
            mod.main(["x.ndjson"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def test_cli_flags_match_jax_and_serve_on_the_cpu(tmp_path, capsys):
    def flags(parser, drop):
        return {a.dest: (a.default, tuple(a.choices or ()), a.option_strings)
                for a in parser._actions if a.dest not in drop}

    assert flags(cli.build_parser(), {"help", "device"}) == flags(fleet_serve_parser(), {"help"})
    assert cli.build_parser().parse_args(["r.ndjson"]).device == "cuda"
    reqs = tmp_path / "req.ndjson"
    short = [dict(max_clock=30, seed=3), dict(max_clock=25, commit_chain=2, seed=4, id="b")]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in short))
    out, stream = tmp_path / "out.ndjson", tmp_path / "stream.ndjson"
    assert cli.main([str(reqs), "--device", "cpu", "--slots", "1", "--chunk", "16",
                     "--watchdog", "--out", str(out), "--stream", str(stream),
                     "--checkpoint", str(tmp_path / "ck.npz")]) == 0
    assert "# served 2 requests on 1 slots" in capsys.readouterr().err
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["request_id"] for r in rows] == ["1", "b"]
    p = SimParams(n_nodes=4, watchdog=True)
    for r, kw in zip(rows, short):
        want = result_fields(dedicated(p, sc.ScenarioSpec(
            **{k: v for k, v in kw.items() if k != "id"})))
        assert {k: r[k] for k in want} == want
        assert "watchdog" in r and "telemetry" not in r
    assert (tmp_path / "ck.npz.serve.json").exists()
    bad = tmp_path / "bad.ndjson"
    bad.write_text("{\n")
    assert cli.main([str(bad), "--device", "cpu"]) == 1
    assert "bad.ndjson:1: not JSON" in capsys.readouterr().err


class _Shard:
    """A jax.Shard's face over a numpy block (JAX's gathers then index
    numpy: no executable)."""

    def __init__(self, start, data):
        self.index, self.data = (slice(start, start + len(data)),), data


class _Array:
    def __init__(self, blocks):
        self.addressable_shards = [_Shard(s, b) for s, b in blocks]
        self.shape = (sum(len(b) for _, b in blocks),) + blocks[0][1].shape[1:]


def test_egress_host_functions_match_jax(tmp_path):
    p = SimParams(**FLEET_SER_KW)
    jp = JParams(**FLEET_SER_KW)
    b, n_valid = 6, 5
    host = S.init_batch(p, np.arange(b), device="cpu")
    host = host.replace(clock=torch.arange(b, dtype=torch.int32) * 7)
    leaves = convert.to_reference(host)
    # Mesh arithmetic: a JAX mesh of one CPU device, and meshes of fake
    # devices of one process against the port's CPU meshes.
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "mp"))
    for n in (1, 2, 3):
        fake = types.SimpleNamespace(devices=np.asarray(
            [types.SimpleNamespace(process_index=0) for _ in range(n)]))
        pm = M.make_mesh(n, 1, devices=["cpu"] * n)
        for batch, valid, pid in ((6, None, None), (6, 5, 0), (6, 4, 1), (6, 1, 0)):
            assert egress.local_spans(pm, batch, valid, pid) == \
                jegress.local_spans(fake, batch, valid, pid)
    assert egress.local_spans(M.make_mesh(1, 1, devices=["cpu"]), b, n_valid) == \
        jegress.local_spans(jmesh, b, n_valid)
    with pytest.raises(ValueError, match="does not tile"):
        egress.local_spans(M.make_mesh(4, 1, devices=["cpu"] * 4), b)
    # Row landing from two shards.
    fleet = M.shard_batch(M.make_mesh(2, 1, devices=["cpu"] * 2), host)
    jfleet = {k: _Array([(0, v[:3]), (3, v[3:])]) for k, v in leaves.items()}
    want = jegress.local_rows_at(jfleet, [4, 1, 4, 7])
    got = egress.local_rows_at(fleet, [4, 1, 4, 7])
    assert list(got) == list(want) == [1, 4]
    for g in got:
        for k, v in convert.to_reference(got[g]).items():
            np.testing.assert_array_equal(v[0], want[g][k], err_msg=k)
    jstate = {k: _Array([(0, v[:3]), (3, v[3:])]) for k, v in leaves.items()}
    jhost = jegress.local_state(jstate, b)
    for k, v in convert.to_reference(egress.local_state(fleet, b)).items():
        np.testing.assert_array_equal(v, jhost[k], err_msg=k)
    trimmed = convert.to_reference(egress.local_state(fleet, n_valid))
    assert all(np.array_equal(v, leaves[k][:n_valid]) for k, v in trimmed.items())
    assert egress.local_state(host, n_valid) is host
    # Checkpoint shards: the port's and JAX's writers on the same rows (a
    # JAX SimState shaped by eval_shape around the port's leaves).
    shape = jax.eval_shape(lambda: JS.init_batch(jp, np.zeros(n_valid, np.uint32)))
    part = {k: v[:n_valid] for k, v in leaves.items()}
    jst = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shape), list(part.values()))
    ctx = types.SimpleNamespace(process_id=0, process_count=1)
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    egress.save_shards(str(dirs["port"]), M.rows_of(host, 0, n_valid, "cpu"), n_valid,
                       M.make_mesh(1, 1, devices=["cpu"]), ctx)
    jegress.save_shards(str(dirs["jax"]), jst, n_valid, jmesh, ctx)
    side = [json.loads((d / "shard-0.json").read_text()) for d in dirs.values()]
    assert side[0] == side[1]
    blobs = [np.load(d / "shard-0.npz") for d in dirs.values()]
    assert blobs[0].files == blobs[1].files
    for k in blobs[1].files:
        np.testing.assert_array_equal(blobs[0][k], blobs[1][k], err_msg=k)
    merged = [egress.merge_shards(str(dirs["jax"]), str(tmp_path / "a.npz")),
              jegress.merge_shards(str(dirs["port"]), str(tmp_path / "b.npz"))]
    a, c = (np.load(m) for m in merged)
    assert a.files == c.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    # A padded two-shard fleet saves its valid rows only.
    egress.save_shards(str(tmp_path / "two"), fleet, n_valid,
                       M.make_mesh(2, 1, devices=["cpu"] * 2), ctx)
    two = np.load(egress.merge_shards(str(tmp_path / "two")))
    np.testing.assert_array_equal(two["clock"], leaves["clock"][:n_valid])
    (tmp_path / "gap").mkdir()
    errs = []
    for fn in (egress.merge_shards, jegress.merge_shards):
        with pytest.raises(FileNotFoundError) as e:
            fn(str(tmp_path / "gap"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    # The per-host stream names and the metric fold.
    assert egress.host_stream_path("f/fleet.ndjson", 3) == \
        jegress.host_stream_path("f/fleet.ndjson", 3) == "f/fleet.p3.ndjson"
    assert egress.host_stream_path("fleet", 0) == jegress.host_stream_path("fleet", 0)
    ctx2 = types.SimpleNamespace(process_id=1, process_count=2)
    assert egress.host_meta(ctx2) == jegress.host_meta(ctx2)
    from librabft_simulator_tpu_torch.telemetry import plane

    rng = np.random.default_rng(0)
    reg = plane.np_registry(p)
    dicts = [{name: (int(rng.integers(0, 99)) if size == 1
                     else rng.integers(0, 99, size).tolist())
              for name, (_, size, _) in reg.items()} for _ in range(3)]
    assert egress.fold_metric_dicts(p, dicts) == jegress.fold_metric_dicts(jp, dicts)
    with pytest.raises(ValueError, match="at least one"):
        egress.fold_metric_dicts(p, [])


# ---------------------------------------------------------------------------
# (e) the lane engine.
# ---------------------------------------------------------------------------


def test_lane_serve_equals_a_static_lane_fleet():
    p = SimParams(**dict(FLEET_SCENARIO_LANE_KW, max_clock=60))
    lane_specs = [sc.ScenarioSpec(delay_kind="uniform", max_clock=60, seed=5),
                  sc.ScenarioSpec(delay_kind="uniform", max_clock=25, commit_chain=2, seed=6),
                  sc.ScenarioSpec(delay_kind="constant", delay_mean=7.0, max_clock=45,
                                  byz_kind="silent", byz_f=1, seed=7)]
    holder = {}
    with pytest.MonkeyPatch.context() as mp:
        reads = Reads(mp, lambda: holder["fleet"])
        fleet = holder["fleet"] = service.ResidentFleet(p, slots=2, chunk=4, engine=P,
                                                        device="cpu")
        ids = [fleet.submit(s) for s in lane_specs]
        res = fleet.drain()
    assert reads.counts["digest"] == fleet.chunks_polled
    static = convert.to_reference(P.run_to_completion(
        p, sc.init_specs(p, lane_specs, engine=P, device="cpu")))
    inbox = tuple(P.INBOX)
    for i, rid in enumerate(ids):
        row = {k: v[i:i + 1] for k, v in static.items()}
        assert {k: res[rid][k] for k in result_fields(row)} == result_fields(row)
        assert_leaves_equal(reads.rows[rid], row, skip=("sc_",) + inbox)
    assert res[ids[2]]["slot"] in (0, 1)


# ---------------------------------------------------------------------------
# slow: the JAX package's own ResidentFleet on the same request file.
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("lanes", [False, True])
def test_results_equal_jax_resident_fleet(tmp_path, lanes):
    """The same request file through JAX's ResidentFleet and the port's
    (serial, and lanes at the lane micro shape): results equal field for
    field but the wall-clock ``ttfc_s``."""
    from librabft_simulator_tpu.serve.service import ResidentFleet as JFleet
    from librabft_simulator_tpu.parallel import mesh as jmesh_ops
    from librabft_simulator_tpu.sim import parallel_sim as JP

    kw = dict(FLEET_SCENARIO_LANE_KW, max_clock=60) if lanes else SERVE_KW
    reqs = ([dict(delay_kind="uniform", max_clock=60, seed=5),
             dict(delay_kind="uniform", max_clock=25, commit_chain=2, seed=6),
             dict(delay_kind="constant", delay_mean=7.0, max_clock=45, byz_kind="silent",
                  byz_f=1, seed=7)] if lanes else REQUESTS)
    path = tmp_path / "req.ndjson"
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    jfleet = JFleet(JParams(**kw), slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                    mesh=jmesh_ops.make_mesh(n_dp=1, devices=jax.devices()[:1]),
                    engine=JP if lanes else None)
    for rid, spec in japi.load_requests(str(path)):
        jfleet.submit(spec, request_id=rid)
    want = json.loads(json.dumps(jfleet.drain()))
    svc = api.FleetService(SimParams(**kw), slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                           engine=P if lanes else None, device="cpu")
    ids = svc.submit_file(str(path))
    got = json.loads(json.dumps(svc.drain()))
    assert set(want) == set(ids)
    for rid in ids:
        assert {k: v for k, v in got[rid].items() if k not in WALL_CLOCK} == \
            {k: v for k, v in want[rid].items() if k not in WALL_CLOCK}, rid
