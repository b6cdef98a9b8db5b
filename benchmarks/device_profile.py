"""Device-time breakdown of one warm flagship run on the GPU.

Runs the bench.py pipeline (``synth.bench_dataset``, 15 views of 864 x
1152) twice to compile and warm up, then traces a third run with
``jax.profiler`` and reduces the trace to:

- the run's wall time (host clock, ends in a host copy of the mosaic);
- device busy time (union of the GPU's kernel and copy intervals) and the
  idle share of the window;
- device time per jitted module, and per named scope: the SIFT Gaussian
  scale space (``sift.GAUSS_SCOPE``) and the backward warp
  (``render.WARP_SCOPE``), each as a share of the wall time.

A kernel belongs to a scope through the ``op_name`` metadata in the
optimized HLO, which XLA dumps when the run is launched with
``XLA_FLAGS="--xla_dump_to=<dir> --xla_dump_hlo_as_text"`` and ``--hlo-dir
<dir>`` names the same directory. A fused kernel counts as ``any`` when at
least one of its fused ops carries the scope (an upper bound) and as
``root`` when its own op_name does (a lower bound). Kernels that XLA
launches inside a CUDA graph carry ``hlo_op=command_buffer``; they are
looked up by kernel name instead, and adding
``--xla_gpu_enable_command_buffer=`` to XLA_FLAGS launches every kernel
on its own (``mapped_ns`` says how much device time found its HLO op).

Run: XLA_FLAGS="--xla_dump_to=.hlo_dump --xla_dump_hlo_as_text" \\
     python benchmarks/device_profile.py --hlo-dir .hlo_dump --out profile_out
"""
import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_COMP = re.compile(r"^(?:ENTRY )?%([\w.\-]+) \(")
_INSTR = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = ")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%([\w.\-]+)")
# summary lines a trace may carry beside the per-stream kernel events
_DERIVED_LINES = {"XLA Modules", "XLA Ops", "Steps", "Framework Ops",
                  "Framework Name Scope", "Source code", "XLA TraceMe"}


def hlo_op_names(text: str):
    """Optimized HLO text -> (module name, {instruction: set of op_names of
    the instruction and of every op it fuses}, {instruction: own
    op_name})."""
    module = text.split(",", 1)[0].replace("HloModule", "").strip()
    comp_ops = collections.defaultdict(set)   # computation -> op_names
    instr_calls, own, comp = {}, {}, None
    for line in text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m or comp is None:
            continue
        name = m.group(1)
        op = _OPNAME.search(line)
        own[name] = op.group(1) if op else ""
        if op:
            comp_ops[comp].add(op.group(1))
        instr_calls[name] = _CALLS.findall(line)

    fused = {n: {own[n]}.union(*(comp_ops[c] for c in instr_calls[n]))
             for n in own}
    return module, fused, own


def _norm(name: str) -> str:
    """HLO instruction and kernel names agree up to '.'/'-' vs '_'."""
    return name.replace(".", "_").replace("-", "_")


def load_hlo_dir(path: str):
    """{(module, normalized instruction): (fused op_names, own op_name)}
    from an XLA dump directory (``*after_optimizations.txt``)."""
    table = {}
    for fn in sorted(glob.glob(os.path.join(path,
                                            "*after_optimizations.txt"))):
        with open(fn) as fid:
            module, fused, own = hlo_op_names(fid.read())
        for name, ops in fused.items():
            key = (module, _norm(name))
            prev = table.get(key, (set(), ""))
            table[key] = (prev[0] | ops, prev[1] or own[name])
    return table


def _lookup(hlo, module: str, op: str):
    """Table entry of a kernel: its HLO op name, else the name with a
    kernel-index suffix (``__3``, then ``_1``) dropped."""
    name = _norm(op)
    for cand in (name, re.sub(r"__\d+$", "", name),
                 re.sub(r"_\d+$", "", re.sub(r"__\d+$", "", name))):
        if (module, cand) in hlo:
            return hlo[(module, cand)]
    return None


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path: str, scopes, hlo=None, plane_prefix=
                 "/device:GPU:"):
    """Device-time breakdown from an ``.xplane.pb`` trace.

    ``scopes``: named scopes to attribute; ``hlo``: the ``load_hlo_dir``
    table. Events on planes whose name starts with ``plane_prefix`` count
    as device work. Returns a dict of nanosecond totals.
    """
    from jax.profiler import ProfileData
    hlo = hlo or {}
    data = ProfileData.from_file(xplane_path)
    busy, per_module = [], collections.Counter()
    per_scope = {s: collections.Counter() for s in scopes}
    top = collections.Counter()
    n_events = mapped = 0
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line.name in _DERIVED_LINES:
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                dur = int(ev.duration_ns)
                if dur <= 0 or ev.name.startswith("end: "):
                    continue
                n_events += 1
                busy.append((int(ev.start_ns), int(ev.start_ns) + dur))
                module = str(stats.get("hlo_module", ""))
                op = str(stats.get("hlo_op", ev.name))
                if op == "command_buffer":      # a kernel in a CUDA graph
                    op = ev.name
                per_module[module] += dur
                top[(module, op)] += dur
                entry = _lookup(hlo, module, op)
                if entry is not None:
                    mapped += dur
                fused, own = entry or (set(), "")
                text = " ".join(str(v) for v in stats.values())
                for s in scopes:
                    if s in own or s in text:
                        per_scope[s]["root"] += dur
                    if s in text or any(s in o for o in fused):
                        per_scope[s]["any"] += dur
    return {"events": n_events, "busy_ns": _union(busy),
            "mapped_ns": mapped,
            "per_module_ns": dict(per_module.most_common()),
            "per_scope_ns": {s: dict(c) for s, c in per_scope.items()},
            "top_ops_ns": [[m, o, t] for (m, o), t in top.most_common(25)]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="profile_out")
    parser.add_argument("--hlo-dir", default=None,
                        help="XLA's --xla_dump_to directory of this run")
    args = parser.parse_args(argv)

    import jax
    # every program must compile in this process, so that XLA dumps its
    # optimized HLO for the scope attribution
    jax.config.update("jax_enable_compilation_cache", False)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"device_profile measures the GPU; found "
                         f"{dev.platform}")

    import bench
    from pano360 import render
    from pano360.features import sift
    from pano360.synth import bench_dataset

    imgs, _, _ = bench_dataset()
    for _ in range(2):
        bench.run_pipeline(imgs)

    tmp = os.path.join(args.out, "trace")
    shutil.rmtree(tmp, ignore_errors=True)
    jax.profiler.start_trace(tmp)
    t0 = time.time()
    bench.run_pipeline(imgs)
    wall = time.time() - t0
    jax.profiler.stop_trace()

    xplane = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                       recursive=True)[0]
    hlo = load_hlo_dir(args.hlo_dir) if args.hlo_dir else {}
    scopes = (sift.GAUSS_SCOPE, render.WARP_SCOPE)
    red = reduce_trace(xplane, scopes, hlo)
    wall_ns = wall * 1e9
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "wall_s": wall,
        "device_busy_s": red["busy_ns"] / 1e9,
        "idle_share": 1 - red["busy_ns"] / wall_ns,
        "scope_share_of_wall": {
            s: {k: v / wall_ns for k, v in c.items()}
            for s, c in red["per_scope_ns"].items()},
        "hlo_instructions_mapped": len(hlo),
        **red,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile.json"), "w") as fid:
        json.dump(out, fid, indent=1)
    print(json.dumps({k: out[k] for k in (
        "device", "wall_s", "device_busy_s", "idle_share",
        "scope_share_of_wall", "events", "mapped_ns", "busy_ns",
        "hlo_instructions_mapped")}),
        flush=True)
    for module, ns in list(red["per_module_ns"].items())[:12]:
        print(f"  module {module}: {ns / 1e6:.3f} ms", flush=True)
    # keep the raw trace for offline reduction only while it is small
    if os.path.getsize(xplane) > (24 << 20):
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
