"""Per-OPERATOR device-time attribution for one TPC-H query on the GPU.

PlanRunner.exec wraps every node in jax.named_scope("qop<idx>_<Type>"), and XLA
keeps those scopes in each HLO instruction's metadata (op_name). This tool dumps
the optimized HLO (XLA_FLAGS=--xla_dump_to), maps each instruction (fusion.N,
sort.N, ...) to its innermost qop scope, traces a few warm executions with
jax.profiler, and sums the kernel durations on the GPU device planes by operator.

    python tools/op_profile.py <q> [--sf 1] [--reps 3] [--seed 0]

Data is generated from the seed in-process. Prints per-operator ms/exec plus the
heaviest instructions. Run it in a fresh process: XLA_FLAGS is read when the
backend starts.

The program it traces is built without command buffers (CUDA graphs), which
would fold every kernel into one event with no HLO op to attribute. Normal
execution keeps them on, so these per-operator times are not the device time
of the program `Database.execute` runs, and are not to be set beside its wall
time unless a run shows the two builds take the same device time.
"""

import argparse
import glob
import os
import re
import shutil
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

WORK = os.path.join(REPO_ROOT, "data", "op_profile")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("q", type=int)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    dump = os.path.join(WORK, "hlo")
    logdir = os.path.join(WORK, f"trace_q{args.q}")
    for d in (dump, logdir):
        shutil.rmtree(d, ignore_errors=True)
    # command buffers (CUDA graphs) would fold every kernel into one
    # "command_buffer" event with no HLO op to attribute
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
                               " --xla_gpu_enable_command_buffer=")
    import jax
    # a persistent-cache hit skips the compile, and with it the HLO dump
    jax.config.update("jax_enable_compilation_cache", False)
    from quickstep_tpu import Database
    from quickstep_tpu.bench.tpch import TPCH_QUERIES, load_tpch

    db = Database()
    load_tpch(db, scale=args.sf, seed=args.seed)
    sql = TPCH_QUERIES[args.q]
    db.execute(sql)  # compile (dumps HLO) + warm
    with jax.profiler.trace(logdir):
        for _ in range(args.reps):
            db.execute(sql)
    op_of = parse_dumps(dump)
    xs = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    if not xs:
        print("no xplane under", logdir)
        return
    from jax.profiler import ProfileData
    with open(xs[0], "rb") as f:
        p = ProfileData.from_serialized_xspace(f.read())
    planes = planes_of(p)
    for plane_name, lines in planes:   # what the trace holds, for a reader
        print(f"plane {plane_name}: " + ", ".join(
            f"{ln}[{len(evs)}]" for ln, evs in lines))
        first = next((evs[0] for _ln, evs in _device_lines(lines) if evs),
                     None)
        if plane_name.startswith("/device:GPU:") and first is not None:
            print(f"  first event {first[0]!r} stats {sorted(first[2])}")
    per_op, per_instr, total = reduce_planes(planes, op_of)
    print(f"device: {jax.devices()[0].device_kind}")
    print(f"total kernel time: {total / 1e9 / args.reps:.3f} ms/exec "
          f"({args.reps} reps)")
    for scope, ps in sorted(per_op.items(), key=lambda kv: -kv[1]):
        print(f"{ps / 1e9 / args.reps:9.3f} ms  "
              f"{100 * ps / max(total, 1):5.1f}%  {scope}")
    print("---- heaviest instructions ----")
    for (scope, name), ps in sorted(per_instr.items(),
                                    key=lambda kv: -kv[1])[:25]:
        print(f"{ps / 1e9 / args.reps:9.3f} ms  {scope:28s} {name}")


_META = re.compile(r'%?([a-zA-Z0-9_.\-]+) = .*metadata=\{[^}]*'
                   r'op_name="([^"]*)"')


def _innermost_qop(op_name: str):
    scopes = [s for s in op_name.split("/") if s.startswith("qop")]
    return scopes[-1] if scopes else None


def parse_hlo_text(text: str, op_of: dict) -> None:
    """Add instruction name -> innermost qop scope for one HLO module."""
    cur_comp = None
    comp_votes = {}
    for line in text.splitlines():
        if line.startswith("%") or line.startswith("ENTRY") or \
                re.match(r"^[a-zA-Z_][\w.\-]* ", line):
            cur_comp = line.split(" ", 1)[0].lstrip("%")
            if cur_comp == "ENTRY":
                cur_comp = line.split(" ", 2)[1].lstrip("%")
        m = _META.search(line)
        if not m:
            continue
        scope = _innermost_qop(m.group(2))
        op_of.setdefault(m.group(1), scope or "(top)")
        if scope and cur_comp:
            votes = comp_votes.setdefault(cur_comp, {})
            votes[scope] = votes.get(scope, 0) + 1
    # fusions whose own metadata lacks a qop scope take the majority scope
    # of their fused computation's instructions
    for line in text.splitlines():
        fm = re.search(r"%?([a-zA-Z0-9_.\-]+) = .* fusion\(.*calls=%?"
                       r"([a-zA-Z0-9_.\-]+)", line)
        if fm:
            name, comp = fm.group(1), fm.group(2)
            if op_of.get(name) in (None, "(top)") and comp in comp_votes:
                best = max(comp_votes[comp].items(), key=lambda kv: kv[1])
                op_of[name] = best[0]


def parse_dumps(dump_dir: str) -> dict:
    """instruction name -> innermost qop scope, over every optimized module."""
    op_of = {}
    for path in glob.glob(os.path.join(dump_dir,
                                       "*after_optimizations.txt")):
        with open(path) as f:
            parse_hlo_text(f.read(), op_of)
    return op_of


def planes_of(profile):
    """ProfileData -> [(plane, [(line, [(event, duration_ps, stats)])])]."""
    out = []
    for plane in profile.planes:
        lines = []
        for line in plane.lines:
            evs = []
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                evs.append((ev.name, int(ev.duration_ns * 1000), stats))
            lines.append((line.name, evs))
        out.append((plane.name, lines))
    return out


def _device_lines(lines):
    """Kernel lines of one GPU plane. The derived "XLA Ops" line, where the
    profiler writes one, already holds every op once; otherwise the raw
    per-stream lines do."""
    ops = [ln for ln in lines if ln[0] == "XLA Ops"]
    if ops:
        return ops
    return [ln for ln in lines if ln[0].startswith("Stream")]


def reduce_planes(planes, op_of: dict):
    """Sum device durations by plan operator.

    planes: [(plane name, [(line name, [(event name, duration ps, stats)])])]
    as planes_of gives them. Only GPU device planes ("/device:GPU:<n>")
    count. An event's HLO instruction is its "hlo_op" stat, else the first
    word of its name; its operator is that instruction's qop scope in
    `op_of`, else the innermost qop scope named in any of its string stats.
    Returns (ps by operator, ps by (operator, instruction), total ps)."""
    per_op, per_instr, total = {}, {}, 0
    for plane_name, lines in planes:
        if not plane_name.startswith("/device:GPU:"):
            continue
        for _line_name, events in _device_lines(lines):
            for name, dur, stats in events:
                dur = int(stats.get("device_duration_ps", dur))
                instr = str(stats.get("hlo_op") or
                            name.split(" ")[0]).lstrip("%")
                scope = op_of.get(instr)
                if scope is None:
                    scope = next(
                        (s for s in (_innermost_qop(v) for v in stats.values()
                                     if isinstance(v, str)) if s),
                        "(unattributed)")
                per_op[scope] = per_op.get(scope, 0) + dur
                per_instr[(scope, instr)] = \
                    per_instr.get((scope, instr), 0) + dur
                total += dur
    return per_op, per_instr, total


if __name__ == "__main__":
    main()
