"""Print the measurements behind three port-against-JAX test checks, on the
CPU (run from the repository's root):

    python scripts/measure_test_margins.py premise [threads]
    python scripts/measure_test_margins.py export

`premise`: `tests/test_torch_sp_train.py::test_bf16_gradients_held_to_jax_bf16`'s
distances (cosine and largest entry) between the port's bf16 gradients and
the same with its convolutions summed in f32, over JAX's bf16-to-f32
distance, under `threads` torch threads (default 1).
`export`: for the export CLI test's three images, JAX's own eager and jitted
exports against each other, the port against the jitted one, and the port
with `torch.linalg.inv` in place of its `invert_homography` (JAX's CPU
arithmetic) against the jitted one (largest score and xy differences on the
keypoints they share).
"""
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]
import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def premise(threads: int = 1):
    import test_torch_sp_train as t

    torch.set_num_threads(threads)
    jf, _ = t._gradients("float32")
    jb, pb = t._gradients("bfloat16")
    biases = [k for k in jf if k.endswith("bias") and ("Conv_0" in k or k.split("::")[1].startswith("conv"))]
    keys = sorted(set(jf) - set(biases))
    scale = max(np.abs(jf[k]).max() for k in jf)

    def dists(a, b):
        va, vb = (np.concatenate([g[k].ravel() for k in keys]) for g in (a, b))
        return np.array([1 - va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)),
                         max(np.abs(a[k] - b[k]).max() for k in keys) / scale])

    order = dists(pb, t._port_gradients("bfloat16", t._conv2d_f32_sums))
    print(f"{threads} torch threads: order / jj (cosine, largest entry) = {order / dists(jb, jf)}")


def _matched(a, b):
    ia, ib = (np.lexsort(np.round(x[:, 1::-1]).T) for x in (a, b))
    return a[ia], b[ib]


def export():
    import test_torch_export as t
    from image_matching_tpu import export as jexport
    from image_matching_tpu_torch import export as pexport
    from image_matching_tpu_torch.data.datasets import _load_gray
    from image_matching_tpu_torch.models import SuperPointBN
    from image_matching_tpu_torch.train.checkpoint import load_weights

    torch.set_num_threads(1)
    d = tempfile.mkdtemp()
    t._write_pngs(d, 3, 4)
    images = np.stack([_load_gray(os.path.join(d, f"im_{i}.png")) for i in range(3)])
    jm, variables = t._jax_variables()
    jcfg, pcfg = jexport.ExportConfig(num_homographies=t.N), pexport.ExportConfig(num_homographies=t.N)
    apply_fn = lambda views: jm.apply(variables, views)["semi"]  # noqa: E731
    model = SuperPointBN(128, device="cpu")
    load_weights(model, t.SP_SYNTH)
    key = jax.random.PRNGKey(3)
    for first, batch in ((0, images[:2]), (2, images[2:])):  # the CLI's batches of 2 and 1
        key, k = jax.random.split(key)
        jit = jax.jit(lambda kk, im: jexport.export_pseudo_labels(kk, apply_fn, im, jcfg))(k, jnp.asarray(batch))
        with jax.disable_jit():
            eager = jexport.export_pseudo_labels(k, apply_fn, jnp.asarray(batch), jcfg)
        hs = torch.from_numpy(t.jax_export_homographies(k, len(batch), t.H, t.W, jcfg))
        apply = lambda v: model(v)["semi"]  # noqa: E731
        with torch.no_grad():
            port = pexport.export_pseudo_labels(hs, apply, torch.from_numpy(batch), pcfg)
            real = pexport.invert_homography
            pexport.invert_homography = torch.linalg.inv
            mkl = pexport.export_pseudo_labels(hs, apply, torch.from_numpy(batch), pcfg)
            pexport.invert_homography = real
        rows = {}
        for name, kp in (("jit", jit), ("eager", eager), ("port", port), ("linalg.inv", mkl)):
            xy, score, mask = (np.asarray(x) for x in (kp.xy, kp.score, kp.mask))
            rows[name] = [np.concatenate([xy[i], score[i][:, None]], 1)[mask[i]] for i in range(len(batch))]
        for i in range(len(batch)):
            for a, b in (("eager", "jit"), ("port", "jit"), ("linalg.inv", "jit")):
                x, y = _matched(rows[a][i], rows[b][i])
                print(f"im_{first + i}: {a} vs {b}: score {np.abs(x[:, 2] - y[:, 2]).max():.3g}, "
                      f"xy {np.abs(x[:, :2] - y[:, :2]).max():.3g} px ({len(x)} keypoints)")


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "premise"
    premise(int(sys.argv[2]) if len(sys.argv) > 2 else 1) if what == "premise" else export()
