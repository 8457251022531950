"""Profile the settled fused-CEM dispatch on the real chip with an xplane
trace, and print the per-op time breakdown (raster kernel vs prep vs
scoring vs everything else).

The settled steady state is the semantic throughput budget: one fused dispatch per frame at iters x samples with ROI
windows. This tool times that dispatch in isolation (drained, repeated,
best-of) and attributes device time to op categories by parsing the
xplane proto that jax.profiler writes.
"""
import argparse
import glob
import gzip
import json
import os
import sys
import time

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))


def build_scene(iters, samples, sigma, roi):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu.image.edges import depth_edge
    from visma_tpu.io.procedural import bench_mesh_db
    from visma_tpu.render import Intrinsics
    from visma_tpu.semantic.cem import (CEM_TAU, cem_n_elite,
                                        fused_cem_executor)
    from visma_tpu.render.raster import MultiMeshRenderer

    intr = Intrinsics(fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                      rows=500, cols=960, z_near=0.05, z_far=8.0)
    db = bench_mesh_db()
    mr = MultiMeshRenderer(intr)
    mr.set_meshes(db)
    names = ["chair", "desk", "chair", "desk"]
    rng = np.random.default_rng(3)
    slots = [(-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75)]
    poses = []
    for k in range(4):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(-0.6, 0.6)
                                        ).as_matrix()
        x, z = slots[k]
        T[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        poses.append(T[:3, :4])
    poses = np.stack(poses).astype(np.float32)
    mi = jnp.asarray(np.array([mr.index(n) for n in names], np.int32))

    d = mr.render_depth(jnp.asarray(poses), mi)
    obs = depth_edge(jnp.min(d, axis=0))

    n = 4
    sig = jnp.asarray(np.tile(np.concatenate(
        [np.full(3, sigma[1]), np.full(3, sigma[0])]).astype(np.float32),
        (n, 1)))
    run = fused_cem_executor(intr, CEM_TAU, iters, samples,
                             cem_n_elite(samples), roi, "poses")
    args = (mr.Cs, mi, jnp.asarray(poses[:, :, :3]), jnp.asarray(poses[:, :, 3]),
            sig, obs, jax.random.PRNGKey(0), jnp.asarray(poses))
    return run, args


def categorize(name):
    n = name.lower()
    if "chunk_raster" in n or "pallas" in n or "custom-call" in n:
        return "raster_kernel"
    if "top_k" in n or "topk" in n or "sort" in n:
        return "binning_topk"
    if "dot" in n or "conv" in n:
        return "matmul"
    if "reduce_window" in n:
        return "score_dilate"
    if any(k in n for k in ("dynamic-slice", "dynamic_slice",
                            "dynamic-update", "gather", "scatter")):
        return "slicing_gather"
    if "transpose" in n or "copy" in n or "reshape" in n or "bitcast" in n:
        return "layout"
    if "fusion" in n:
        return "fusion_elementwise"
    if "reduce" in n:
        return "reduce"
    return "other"


def parse_xplane(logdir):
    """Sum device-op durations by category from the newest trace.json.gz
    (the xplane proto bindings in this container fail to import; the
    Chrome-trace export carries the same device op stream)."""
    import json as _json

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None, None
    with gzip.open(paths[-1]) as fp:
        data = _json.load(fp)
    ev = data.get("traceEvents", [])
    dev_pids = {e["pid"] for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:" in e.get("args", {}).get("name", "")}
    cats = {}
    ops = {}
    total = 0
    for e in ev:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        nm = e.get("name", "?")
        dur = e.get("dur", 0)            # us
        cats[categorize(nm)] = cats.get(categorize(nm), 0) + dur
        ops[nm] = ops.get(nm, 0) + dur
        total += dur
    return cats, sorted(ops.items(), key=lambda kv: -kv[1])[:25]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--sigma", type=float, nargs=2, default=[0.05, 0.03])
    ap.add_argument("--roi", type=int, nargs=2, default=[256, 256])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--logdir", default=os.path.join(
        os.path.dirname(__file__), "..", "chiprun_out", "cem_trace"))
    args = ap.parse_args()

    import jax
    import numpy as np

    print("backend:", jax.default_backend(), file=sys.stderr)
    run, a = build_scene(args.iters, args.samples, tuple(args.sigma),
                        tuple(args.roi))
    t0 = time.time()
    out = run(*a)
    np.asarray(out[0])
    print(f"compile+first: {time.time()-t0:.1f}s", file=sys.stderr)

    times = []
    for _ in range(args.reps):
        t0 = time.time()
        np.asarray(run(*a)[0])
        times.append(time.time() - t0)
    ms = [round(t * 1e3, 1) for t in times]
    print(f"dispatch ms: best {min(ms)} p50 {sorted(ms)[len(ms)//2]} "
          f"all {ms}", file=sys.stderr)

    if args.trace:
        os.makedirs(args.logdir, exist_ok=True)
        with jax.profiler.trace(args.logdir):
            for _ in range(3):
                np.asarray(run(*a)[0])
        cats, top = parse_xplane(args.logdir)
        if cats is None:
            print("no xplane found", file=sys.stderr)
        else:
            tot = sum(cats.values())
            print(f"\ndevice op time over 3 dispatches (nested ops "
                  f"double-count): {tot/1e3:.2f} ms")
            for k, v in sorted(cats.items(), key=lambda kv: -kv[1]):
                print(f"  {k:22s} {v/3e3:8.3f} ms/dispatch "
                      f"{100*v/tot:5.1f}%")
            print("\ntop ops (us over 3 dispatches):")
            for nm, us in top:
                print(f"  {us:10.0f}  {nm[:110]}")


if __name__ == "__main__":
    main()
