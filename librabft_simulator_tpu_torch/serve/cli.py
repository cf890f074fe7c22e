"""NDJSON front end of the resident fleet service: the port of
``scripts/fleet_serve.py``.

Reads scenario requests from an NDJSON file (one JSON object per line, see
serve/api.py for the schema), serves them on a resident fleet, and writes
per-request results as NDJSON, in submission order.

    python -m librabft_simulator_tpu_torch.serve.cli requests.ndjson
    python -m librabft_simulator_tpu_torch.serve.cli requests.ndjson \\
        --out results.ndjson --slots 8 --chunk 64 --dp 2 --stream serve.ndjson
    python -m librabft_simulator_tpu_torch.serve.cli requests.ndjson --device cpu

``--slots`` / ``--chunk`` (default 8 and 64) are the residency geometry;
per-request scenario knobs ride the requests themselves.  ``--device``
(default ``cuda``) places the fleet; ``--dp N`` splits it over N shards
(N cards, or N shards of the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("requests", help="NDJSON request file")
    ap.add_argument("--out", default=None,
                    help="results NDJSON path (default: stdout)")
    ap.add_argument("--slots", type=int, default=None, help="fleet slots (default 8)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="macro-steps per dispatched chunk (default 64)")
    ap.add_argument("--dp", type=int, default=1,
                    help="dp mesh width (shards; default 1)")
    ap.add_argument("--nodes", type=int, default=4,
                    help="committee size every scenario shares (structural)")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm the telemetry plane (per-request metrics ride "
                         "the egress results)")
    ap.add_argument("--watchdog", action="store_true",
                    help="arm the consensus watchdog (trip counts ride the "
                         "streamed digests and the results)")
    ap.add_argument("--stream", default=None,
                    help="live digest+request NDJSON stream path")
    ap.add_argument("--checkpoint", default=None,
                    help="preempt after draining: checkpoint the resident "
                         "state here (resume with FleetService.resume)")
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="chunk ceiling for the serve loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fleet runs (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..core.types import SimParams
    from ..parallel import mesh as mesh_ops
    from . import FleetService, load_requests

    try:
        requests = load_requests(args.requests)
    except (OSError, ValueError) as e:
        print(f"serve.cli: {e}", file=sys.stderr)
        return 1

    p = SimParams(n_nodes=args.nodes, telemetry=args.telemetry, watchdog=args.watchdog)
    mesh = None
    if args.dp > 1:
        devices = ([args.device] * args.dp if args.device == "cpu"
                   else mesh_ops.visible_devices()[:args.dp])
        mesh = mesh_ops.make_mesh(n_dp=args.dp, n_mp=1, devices=devices)
    out_f = open(args.out, "w") if args.out else sys.stdout
    try:
        with FleetService(p, slots=args.slots, chunk=args.chunk, mesh=mesh,
                          out=args.stream, device=args.device) as svc:
            for rid, spec in requests:
                svc.submit(spec, request_id=rid)
            kw = {} if args.max_chunks is None else {"max_chunks": args.max_chunks}
            results = svc.drain(**kw)
            for rid, _ in requests:  # submission order, not egress order
                out_f.write(json.dumps(results[rid]) + "\n")
                out_f.flush()  # per row: a killed run keeps the landed rows
            occ = svc.fleet.occupancy()
            print(f"# served {len(results)} requests on {occ['slots']} "
                  f"slots, {svc.fleet.chunks_polled} chunks", file=sys.stderr)
            if args.checkpoint:
                svc.preempt(args.checkpoint)
                print(f"# resident state checkpointed to "
                      f"{args.checkpoint} (+.serve.json)", file=sys.stderr)
    finally:
        if args.out:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
