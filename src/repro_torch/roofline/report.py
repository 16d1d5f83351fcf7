"""Tables of a dry run and of the card's roofline runs: the counterpart of
``src/repro/roofline/report.py``.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        artifacts/dryrun/dryrun_single_multi.json [card_roofline.json]

The dry-run JSON gives the summary of every cell and the roofline per
mesh; a second JSON, ``chip_smoke.py``'s ``roofline_table`` line (or
the list of its records), gives the card's table: the eager bound (the
eager program's own traffic, ``OpCost.bytes``) and the least-traffic
bound (``OpCost.min_bytes``: arguments read and results written once),
each beside the measured ms, and the device's busy share.
"""
from __future__ import annotations

import json
import sys


def fmt_s(x):
    if x is None:
        return "—"
    if x < 1e-3:
        return f"{x * 1e6:.0f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def render(records, mesh_filter="pod16x16"):
    lines = ["| arch | shape | t_compute | t_memory | t_collective | "
             "bottleneck | FLOPs/dev | useful ratio | live GiB |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") != "ok" or r.get("mesh") != mesh_filter:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"**{r['bottleneck']}** | {r['flops_per_device']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r['peak_live_gib']:.2f} |")
    skips = [r for r in records if r.get("status") == "skipped"
             and r.get("mesh") == mesh_filter]
    if skips:
        lines += ["", "Skipped cells (``configs.shapes.cell_applicable``):"]
        lines += [f"- {r['arch']} × {r['shape']}" for r in skips]
    return "\n".join(lines)


def render_dryrun_summary(records):
    n_ok = sum(1 for r in records if r.get("status") == "ok")
    n_skip = sum(1 for r in records if r.get("status") == "skipped")
    n_err = len(records) - n_ok - n_skip
    lines = [f"Cells: {n_ok} traced ok, {n_skip} documented skips, "
             f"{n_err} errors.", "",
             "| arch | shape | mesh | trace s | live GiB | args GiB | "
             "coll bytes/dev | coll ops |",
             "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") != "ok":
            continue
        kinds = r.get("coll_by_kind", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('t_trace_s', 0):.1f} | {r['peak_live_gib']:.2f} | "
            f"{r.get('mem_args_gib', 0):.2f} | "
            f"{r['coll_bytes_per_device']:.2e} | "
            f"{'+'.join(k for k in sorted(kinds))} |")
    return "\n".join(lines)


def render_card(records):
    """The card's runs: each record holds ``name``, ``ms``, ``busy``, the
    ``t_compute`` term and the two bounds' memory terms (s) and ms:
    ``t_memory`` / ``eager_bound_ms`` and ``min_t_memory`` /
    ``min_bound_ms``."""
    lines = ["| call | t_compute | t_memory eager | t_memory least | "
             "eager bound ms | least-traffic bound ms | measured ms | "
             "eager bound / measured | least bound / measured | "
             "busy share |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        busy = r.get("busy")
        lines.append(
            f"| {r['name']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['min_t_memory'])} | "
            f"{r['eager_bound_ms']:.3f} | {r['min_bound_ms']:.3f} | "
            f"{r['ms']:.3f} | {r['eager_bound_ms'] / r['ms']:.3f} | "
            f"{r['min_bound_ms'] / r['ms']:.3f} | "
            f"{'not measured' if busy is None else f'{busy:.3f}'} |")
    return "\n".join(lines)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        records = json.load(f)
    print("## Dry run\n")
    print(render_dryrun_summary(records))
    print("\n## Roofline (single-pod 16×16, per cell)\n")
    print(render(records, "pod16x16"))
    print("\n## Roofline (multi-pod 2×16×16)\n")
    print(render(records, "pod2x16x16"))
    if len(argv) > 1:
        with open(argv[1]) as f:
            card = json.load(f)
        print("\n## The card's runs\n")
        print(render_card(card["records"] if isinstance(card, dict)
                          else card))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
