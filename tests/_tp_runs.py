"""The shared body of the tensor-parallel tests (`test_torch_dist_tp.py`,
the transformer families; `test_torch_dist_tp_rest.py`, RWKV6, Hymba,
whisper and the model line's operators and traffic).

`run` starts, side by side, one JAX subprocess (`_auto_ref.CHILD`: the
reference's `make_train_step` on plain `jax.sharding.Mesh`es, (2, 2) and
(1, 4) as ("data", "model"), (2, 1, 2) as ("pod", "data", "model"),
`AUTO_STEPS` steps from its own init of each run's widened smoke model)
and one launch of 4 gloo processes (`_dist_workers.tp_worker`, with a
deadline) that train the same runs from that init with the port's auto
engine; then the same runs' f32 cases on one device in this process at
the ranks' one torch thread.

Tolerances: against the reference, f32 within 1e-5 and bf16 within
5e-3 relative at every step (STEP_TOL); against the port's one-device
run, losses and gnorms within 1e-5 relative (ONE_TOL: the ranks sum
their partial products, norms and gradients in another order), and
each rank's final local tensors their slice of the one-device
parameters within 1e-4 in norm, ‖local − slice‖ / ‖slice‖ a leaf
(PARAM_TOL). Not of the largest |value| element by element, as
`test_torch_dist_auto.py` holds its runs: AdamW divides each gradient
element by its own running RMS, so an element whose gradient is near
zero takes an lr-sized step whose size and sign the last bits of a
re-ordered f32 sum decide (≈ 1e-9 absolute at these widths). A row
product's partial sums over the line re-order every layer's forward, so
after 3 steps at lr 1e-3 a few such elements sit up to 1.2e-3 of their
leaf's largest |value| from the one-device run (gemma2-27b's down
product; 1.6e-4 under the DP axes alone), while each leaf's norm error
stays within 3.0e-5 (whisper-large-v3's norms), measured on the CPU."""
import numpy as np
import torch

import _auto_ref as R
import _dist_workers as W
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.launch import train

TIMEOUT_S = 600
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
ONE_TOL = 1e-5
PARAM_TOL = 1e-4
KINDS = {"column", "row", "replicated", "embedding on its hidden dim",
         "head on its vocabulary"}


def batches(runs) -> dict:
    """The explicit batches of `runs`, as `run_training`'s pipeline makes
    them (integers as int32 for both sides); "masked" is stablelm-12b's
    with 8 of rank 0's 64 labels kept, as `test_torch_dist_auto.py`'s."""
    out = {}
    for _, arch, _, _, _, ov, bkey in runs:
        cfg = W.auto_api(arch, ov).cfg
        data = SyntheticLM(train.data_config(cfg, W.AUTO_SEQ, W.AUTO_BATCH))
        for s in range(W.AUTO_STEPS):
            b = {k: v.astype(np.int32) if v.dtype.kind == "i" else v
                 for k, v in data.batch_at(s).items()}
            if bkey == "masked":
                b["mask"] = np.ones((W.AUTO_BATCH, W.AUTO_SEQ), np.float32)
                b["mask"][:W.AUTO_BATCH // 4, 4:] = 0.0
            for k, v in b.items():
                out[f"batch/{bkey}/{s}/{k}"] = v
    return out


def run(d, labels, extras: bool):
    """(the reference's results, the ranks' results, the one-device runs
    of the f32 labels, the inputs) for the TP_RUNS named in `labels`."""
    runs = [r for r in W.TP_RUNS if r[0] in labels]
    inputs = batches(runs)
    np.savez(d / "batches.npz", **inputs)
    child, init_path, out_path = R.spawn(
        d, "ref", runs, d / "batches.npz", lr=W.AUTO_LR, steps=W.AUTO_STEPS)
    try:
        inputs.update(R.wait_init(child, init_path))
        ranks = M.launch(W.tp_worker, W.TP_AXES["2x2"], backend="gloo",
                         device="cpu", timeout_s=TIMEOUT_S, threads=1,
                         args=(str(init_path), str(d / "batches.npz"),
                               tuple(labels), str(d / "ckpt"), extras))
        before = torch.get_num_threads()
        torch.set_num_threads(1)        # the ranks' thread count
        try:
            one = {label: W.auto_steps(None, inputs, label, arch, dtype,
                                       fsdp, ov, bkey)
                   for label, arch, dtype, _, fsdp, ov, bkey in runs
                   if dtype == "float32"}
        finally:
            torch.set_num_threads(before)
        ref = R.finish(child, out_path)
    finally:
        if child.poll() is None:
            child.kill()
    return ref, ranks, one, inputs


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_reference(ref, ranks, label: str) -> None:
    """Every rank's losses and gnorms at every step are the reference's
    within STEP_TOL, the same bits on every rank, and the loss falls."""
    dtype = {r[0]: r for r in W.TP_RUNS}[label][2]
    for res in ranks:
        got = res[label]
        np.testing.assert_allclose(got["losses"], ref[f"{label}/losses"],
                                   rtol=STEP_TOL[dtype], atol=0)
        np.testing.assert_allclose(got["gnorms"], ref[f"{label}/gnorms"],
                                   rtol=STEP_TOL[dtype], atol=0)
        assert got["losses"] == ranks[0][label]["losses"]
        assert got["gnorms"] == ranks[0][label]["gnorms"]
    assert ranks[0][label]["losses"][-1] < ranks[0][label]["losses"][0]


def check_one_device(ranks, one, label: str) -> None:
    """Every rank's losses and gnorms are the one-device run's within
    ONE_TOL, and its local tensors its slice of each leaf at the leaf's
    placements (over the DP axes and "model") within PARAM_TOL in
    norm."""
    want = one[label]
    axes = W.TP_AXES[{r[0]: r for r in W.TP_RUNS}[label][3]]
    sizes = [s for _, s in axes]
    for r, res in enumerate(ranks):
        got = res[label]
        assert rel(got["losses"], want["losses"]) <= ONE_TOL
        assert rel(got["gnorms"], want["gnorms"]) <= ONE_TOL
        coords = M.coords_of(r, sizes)
        for p, w, pl in zip(got["params"], want["params"], got["placements"]):
            for c, n, spec in zip(coords, sizes, pl):
                if spec.startswith("Shard"):
                    dim = int(spec[spec.index("dim=") + 4:].rstrip(")"))
                    size = w.shape[dim] // n
                    w = w.narrow(dim, c * size, size)
            assert p.shape == w.shape
            assert float((p - w).norm() / w.norm()) <= PARAM_TOL


def kinds(ranks, label: str) -> set:
    """The kinds of "model" spec among run `label`'s leaves: a layer leaf
    on its last dim (a product's output: column) or the one before
    (its contraction: row), a leaf "model" leaves whole (replicated), the
    embedding on its hidden dim, the head on its vocabulary."""
    run = {r[0]: r for r in W.TP_RUNS}[label]
    api = W.auto_api(run[1], run[5])
    names = [a for a, _ in W.TP_AXES[run[3]]]
    out = set()
    for (path, leaf), pl in zip(W.tree_items_of(api),
                                ranks[0][label]["placements"]):
        q = pl[names.index("model")]
        if not q.startswith("Shard"):
            out.add("replicated")
            continue
        dim = int(q[q.index("dim=") + 4:].rstrip(")"))
        if path == ("embed",):
            out.add("embedding on its hidden dim" if dim == 1 else "other")
        elif path == ("lm_head",):
            out.add("head on its vocabulary" if dim == 1 else "other")
        else:
            out.add({leaf.dim() - 1: "column",
                     leaf.dim() - 2: "row"}.get(dim, "other"))
    return out
