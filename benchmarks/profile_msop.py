"""Per-stage profile of the MSOP extraction path on the GPU.

The reference's per-level MSOP loop maps to: one batched candidate dispatch per
pyramid level, a (n, cap)-sized candidate readback per level for the
host-side SSC suppression, SSC itself, and one batched descriptor
dispatch per level. This splits the wall time across those pieces so
the lever is measured, not guessed. Run:
    python benchmarks/profile_msop.py [n_views [h w]]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano360 import synth  # noqa: E402
from pano360.features import msop as M  # noqa: E402


def main():
    n_views = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    shape = ((int(sys.argv[2]), int(sys.argv[3])) if len(sys.argv) > 3
             else (240, 320))
    views, _, _ = synth.make_views(n_views=n_views, shape=shape,
                                   overlap=0.5, seed=13)
    imgs = [(np.asarray(v) * 255).astype(np.uint8) for v in views]
    n = len(imgs)
    stack = np.stack(imgs)
    print(f"{n} views x {shape}", flush=True)

    def full():
        return M.msop_extract_batch(imgs)

    full()                                 # compile
    reps = []
    for _ in range(3):
        t0 = time.time()
        full()
        reps.append(time.time() - t0)
    print(f"msop_extract_batch total: {sorted(reps)[1]:.3f}s "
          f"(all {[round(r, 3) for r in reps]})", flush=True)

    # ---- split: candidate dispatches / readback / ssc / descriptors
    cur0 = M._msop_gray(jnp.asarray(stack))
    jax.block_until_ready(cur0)

    for rep in range(2):
        t0 = time.time()
        cur = cur0
        levels = []
        for maxf in M.MAX_FEAT:
            out = M._msop_level_batch(cur, maxf * 20)
            levels.append(out[:5] + (cur.shape[1:],))
            cur = out[5]
        jax.block_until_ready(levels[-1][0])
        t_disp = time.time() - t0

        t0 = time.time()
        host = []
        for (vals_d, rows_d, cols_d, theta_d, blurred, hw) in levels:
            host.append((np.asarray(vals_d), np.asarray(rows_d),
                         np.asarray(cols_d), np.asarray(theta_d), hw))
        t_read = time.time() - t0
        nbytes = sum(sum(a.nbytes for a in h[:4]) for h in host)

        t0 = time.time()
        sels = []
        for (vals, rows_a, cols_a, theta_a, hw) in host:
            h, w = hw
            per_img = []
            for i in range(n):
                valid = np.isfinite(vals[i])
                rows = rows_a[i][valid]
                cols = cols_a[i][valid]
                maxf = M.MAX_FEAT[len(sels)]
                sel = M.ssc(np.stack([cols, rows], 1).astype(np.float32),
                            (w, h), maxf)
                per_img.append(sel)
            sels.append(per_img)
        t_ssc = time.time() - t0

        t0 = time.time()
        for lvl, ((vals, rows_a, cols_a, theta_a, hw),
                  (dlev, per_img)) in enumerate(
                zip(host, zip(levels, sels))):
            top = max(len(s) for s in per_img)
            cap = max(64, 1 << (top - 1).bit_length())
            rows_b = np.zeros((n, cap), rows_a.dtype)
            cols_b = np.zeros((n, cap), cols_a.dtype)
            theta_b = np.zeros((n, cap), np.float32)
            for i in range(n):
                valid = np.isfinite(vals[i])
                s = per_img[i]
                rows_b[i, :len(s)] = rows_a[i][valid][s]
                cols_b[i, :len(s)] = cols_a[i][valid][s]
                theta_b[i, :len(s)] = theta_a[i][valid][s]
            desc = M._oriented_descriptors_batch(
                dlev[4], jnp.asarray(rows_b), jnp.asarray(cols_b),
                jnp.asarray(theta_b))
            np.asarray(desc)
        t_desc = time.time() - t0

        if rep:
            print(f"dispatch(all levels): {t_disp:.3f}s", flush=True)
            print(f"candidate readback:   {t_read:.3f}s "
                  f"({nbytes / 1e6:.1f} MB -> "
                  f"{nbytes / 1e6 / max(t_read, 1e-9):.0f} MB/s)",
                  flush=True)
            print(f"ssc (host):           {t_ssc:.3f}s", flush=True)
            print(f"descriptors:          {t_desc:.3f}s", flush=True)


if __name__ == "__main__":
    main()
