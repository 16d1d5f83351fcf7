"""Serve: the async solver server on the card, with a built-in load generator.

Adapted from ``src/repro/launch/serve.py``.  Stands up an
:class:`AsyncSolverServer` over a :class:`SolverService` and drives it
with the fault-injection harness's mixed-pattern stream
(``repro_torch.serve.faultinject``): healthy circuit/banded/denseish
systems interleaved with the full fault matrix at ``--fault-rate``.
Prints a serving report (throughput, p50/p99 latency, deadline-miss /
reject / quarantine rates, per-status outcome counts) and exits nonzero
if the robustness contract is violated (a lost request, a silently wrong
solution, or a healthy request off fp64-oracle parity).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200 \\
        --batch-size 8 --fault-rate 0.2 --deadline-ms 200

Runs on the card (``--device cuda``, the default; without one it raises)
or, with ``--device cpu``, on the plain PyTorch path.  The shard of the
system batch over several devices is not ported (ROADMAP.md, Queue A
item 7): one device serves every dispatch.
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=500,
                   help="stream length (default 500)")
    p.add_argument("--n", type=int, default=32,
                   help="system size per request (default 32)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="dispatch batch size (default 8)")
    p.add_argument("--fault-rate", type=float, default=0.2,
                   help="fraction of the stream replaced by injected "
                        "faults (default 0.2; 0 = pure healthy load)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request latency budget (default: "
                        "none)")
    p.add_argument("--max-queue-per-group", type=int, default=64,
                   help="bounded per-pattern queue depth (default 64)")
    p.add_argument("--max-pending", type=int, default=1024,
                   help="global admission bound (default 1024)")
    p.add_argument("--max-linger-ms", type=float, default=50.0,
                   help="flush a non-empty window at most this long after "
                        "its oldest request arrived (default 50)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default), 'cuda:N', or 'cpu' for the plain "
                        "PyTorch path; one device serves every dispatch "
                        "(the shard over K across devices is not ported)")
    return p


async def _serve_and_drive(args) -> dict:
    from ..core.options import HyluOptions
    from ..serve import faultinject
    from ..serve.async_server import AsyncSolverServer
    from ..serve.solver_service import SolverService

    opts = HyluOptions(deadline_ms=args.deadline_ms, device=args.device)
    service = SolverService(opts=opts, cache_dir=None,
                            batch_size=args.batch_size)
    stream = faultinject.make_stream(args.requests,
                                     fault_rate=args.fault_rate,
                                     seed=args.seed, n=args.n)
    async with AsyncSolverServer(
            service,
            max_queue_per_group=args.max_queue_per_group,
            max_pending=args.max_pending,
            max_linger_ms=args.max_linger_ms,
            default_deadline_ms=args.deadline_ms) as server:
        t0 = time.perf_counter()
        report = await faultinject.run_stream(server, stream)
        report["wall_s"] = time.perf_counter() - t0
    report["device"] = str(service.device)
    return report


def print_report(report: dict, file=sys.stdout) -> None:
    s = report["server_stats"]
    n = report["n_requests"]
    wall = report.get("wall_s") or 1e-9

    def fmt(v, spec=".2f"):
        return "n/a" if v is None else format(v, spec)

    print(f"serve: {n} requests in {wall:.2f}s "
          f"({n / wall:.1f} req/s) on {report.get('device', '?')}",
          file=file)
    print(f"  outcomes: {report['by_status']}", file=file)
    print(f"  lost: {report['lost']}   "
          f"healthy fp64-oracle worst rel err: "
          f"{report['worst_healthy_err']:.3e} "
          f"({report['n_healthy_checked']} checked)", file=file)
    print(f"  latency: p50 {fmt(s['p50_ms'])} ms, p99 {fmt(s['p99_ms'])} ms"
          f"   deadline-miss rate: {s['deadline_miss_rate']:.3f}",
          file=file)
    print(f"  reject rate: {s['reject_rate']:.3f} "
          f"(queue-full {s['rejected_full']}, "
          f"invalid {s['rejected_invalid']})   "
          f"retries: {s['retries']}   quarantined: {s['quarantined']}",
          file=file)
    print(f"  dispatch batches: {s['dispatch_batches']}   "
          f"queue depth at exit: {s['queue_depth']}", file=file)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = asyncio.run(_serve_and_drive(args))
    print_report(report)

    from ..serve.faultinject import check_report
    violations = check_report(report)
    if violations:
        print(f"\nFAIL: {len(violations)} robustness-contract "
              f"violation(s):", file=sys.stderr)
        for v in violations[:20]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    print("\nOK: every request got exactly one terminal result; healthy "
          "traffic at fp64-oracle parity.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
