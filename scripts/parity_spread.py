"""How far rounding alone moves the tiny detection parity checks, on the
CPU: the numbers the parity tests and ``chip_smoke.py`` quote for the
tolerances and seeds they chose.

    python scripts/parity_spread.py slice [--threads 1]
    python scripts/parity_spread.py detection-stream
    python scripts/parity_spread.py detection-meta
    python scripts/parity_spread.py detection-parent
    python scripts/parity_spread.py parent-border
    python scripts/parity_spread.py small-meta

Each prints JSON lines:

* ``slice``: the detection slice test's sequence (test_torch_port_detection
  _slice.py). The JAX reference with its weights scaled by 1 ± eps against
  itself (window boxes and probabilities); the port the same way, against
  its own unscaled run and against JAX; and each stage on identical inputs
  (the port's windows on JAX's parameters, carried boxes and draws; its
  refit from JAX's fine-tuned parameters). ``--threads 1`` runs XLA and
  torch on one thread.
* ``detection-stream``: the four 2-object sequences of
  test_torch_port_detection_entry.py's ``eval_stream`` test, each at
  stream position 0 and 1 (pairs seq00/seq01 and seq02/seq03 in both
  orders): the pixels of the JAX row that weights scaled by 1 ± 1e-6
  move, and the pixels where the port's row (on JAX's draws) differs from
  JAX's.
* ``detection-meta``: the JAX detection meta step of
  test_torch_port_detection_meta.py (per-step mode) on task seeds 0-3,
  weights x (1, 1 ± 1e-6): per-task losses.
* ``detection-parent``: three JAX detection parent Adam steps of
  test_torch_port_parent_trainer.py on sampler seeds 0-2, weights x (1,
  1 ± 1e-6): losses.
* ``parent-border``: the port's DeepLab parent gradient on the port's and
  on JAX's augmentation of one batch under a zoom-out and rotation
  augmentation: the largest difference of each tensor's gradient over its
  largest entry (the warp's fringe pixels differ by rounding; the
  border's max-pool ties route the stem's gradient).
* ``detection-batched``: the 2-object sequence of
  test_torch_port_detection_batched.py through the JAX evaluator with
  objects batched and through the port's, in both window loops: the JAX
  run with its weights scaled by 1 ± eps against itself; the port batched
  on JAX's draws against JAX; the port batched against its own loop on
  its own draws, and its loop against itself under the same scaling
  (probabilities; the seconds of each JAX run).
* ``small-meta``: chip_smoke.py's small detection meta step on this CPU
  for each of its task seeds, weights x (1 ± 1e-6): the meta-loss's
  relative move and the gradient entries over the check's limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"


def out(**kw):
    print(json.dumps(kw), flush=True)


def _scaled(variables, s):
    import jax
    import numpy as np

    return jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(s),
                                  variables)


def slice_spread():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_port_detection_slice as S
    from e_osvos_torch.engine.one_shot import build_pseudo_gt

    rng = np.random.RandomState(0)
    jmodel, variables, _ = S.tiny_pair(detections_per_img=1)
    index = S.JSyntheticVOSIndex(num_sequences=1, num_frames=S.T,
                                 size=(S.SIZE, S.SIZE), seed=4)
    frames = np.stack([index.get_image("seq00", t) for t in range(S.T)])
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(S.j_init_lr_tree(variables["params"], "neuron")))
    j_ev = S.JDetectionOneShotEvaluator(
        jmodel, S.JMetaOptimConfig(use_log_init_lr=False),
        S.JDetectionOneShotConfig(augment=S.JAugmentConfig(**S.AUG_KW),
                                  **S.CFG_KW), fused_ona=True)
    key = jax.random.PRNGKey(11)
    label = jnp.asarray((index.get_label("seq00", 0) == 1).astype(np.int32))

    def jax_run(s):
        _, _, wins, rest = S._jax_group(j_ev, _scaled(variables, s), lrs,
                                        frames, label, key)
        return np.concatenate([w["boxes"] for w in wins]), rest, wins

    def port_run(s):
        _, _, model = S.tiny_pair(detections_per_img=1)
        sd = S.state_dict_from_jax(_scaled(variables, s))
        model.load_state_dict(sd)
        names = {n for n, _ in model.named_parameters()}
        meta = S.MetaParams({k: v for k, v in sd.items() if k in names},
                            S.lr_tree_from_jax(lrs))
        cfg = S.DetectionOneShotConfig(augment=S.AugmentConfig(**S.AUG_KW),
                                       **S.CFG_KW)
        ev = S.DetectionOneShotEvaluator(
            model, S.MetaOptimConfig(use_log_init_lr=False), cfg,
            fused_ona=True, device="cpu")
        ev.sample_draws = S.JaxDraws(jmodel, variables, key, cfg)
        seen, segment = [], ev._segment_window

        def record(*args):
            seen.append(segment(*args))
            return seen[-1]

        ev._segment_window = record
        idx = S.SyntheticVOSIndex(num_sequences=1, num_frames=S.T,
                                  size=(S.SIZE, S.SIZE), seed=4)
        seq = idx.sequences["seq00"]
        probs = ev._eval_object_group(idx, seq, torch.from_numpy(frames),
                                      seq.object_groups[0], meta,
                                      torch.Generator().manual_seed(0), None)
        boxes = np.concatenate([o[1].numpy() for o in seen])
        return boxes, probs.numpy()[1:], ev, meta, cfg

    base_b, base_p, wins = jax_run(1.0)
    for s in (1 + 1e-6, 1 - 1e-6, 1 - 2e-6, 1 + 3e-6, 1 - 3e-6):
        b, p, _ = jax_run(s)
        out(side="jax", scale=s, box_spread=float(np.abs(b - base_b).max()),
            prob_spread=float(np.abs(p - base_p).max()))
    port_b, port_p, ev, meta, cfg = port_run(1.0)
    for s in (1.0, 1 + 1e-6, 1 - 1e-6):
        b, p = (port_b, port_p) if s == 1.0 else port_run(s)[:2]
        out(side="port", scale=s,
            box_vs_jax=float(np.abs(b - base_b).max()),
            prob_vs_jax=float(np.abs(p - base_p).max()),
            box_vs_port=float(np.abs(b - port_b).max()))
    # each stage on identical inputs
    draws = S.JaxDraws(jmodel, variables, key, cfg)
    for w, jw in enumerate(wins):
        draws.calls["frames"] = w
        # the class's method: the instance's is the recording wrapper
        w_probs, b, _, _, _ = type(ev)._segment_window(
            ev, S._port_params(jw["params"]), torch.tensor(jw["frames"]),
            *(torch.tensor(c) for c in jw["carry"]),
            draws(None, "frames", len(jw["frames"]), None))
        out(stage=f"window {w} on JAX's params",
            box_diff=float(np.abs(b.numpy() - jw["boxes"]).max()),
            prob_diff=float(np.abs(w_probs.numpy() - jw["probs"]).max()))
    j_params, j_final, _, _ = S._jax_group(j_ev, variables, lrs, frames,
                                           label, key)
    kk = min(cfg.online_adapt_step, cfg.batch_size)
    pseudo = build_pseudo_gt(torch.tensor(wins[0]["probs"][-kk:]),
                             cfg.online_adapt_min_prop, None)
    ev.sample_draws = draws
    draws.calls["refit"] = 0
    got = ev._ona_fine_tune(meta, None, torch.tensor(frames[0]),
                            torch.tensor(np.asarray(label)),
                            torch.tensor(wins[0]["frames"][-kk:]), pseudo,
                            dict(S._port_params(j_params)))
    want = S._port_params(j_final)
    out(stage="refit from JAX's fine-tuned params", rel_diff=max(
        float((got[k].detach() - want[k]).abs().max() / want[k].abs().max())
        for k in want))


def detection_batched():
    import time

    import numpy as np

    import test_torch_port_detection_batched as D

    def run_jax(j_ev, variables, pair):
        meta = D.JMetaParams(model_init=variables,
                             log_init_lr={"params": pair["lrs"]})
        t0 = time.perf_counter()
        res = j_ev.eval_sequence(D.JSyntheticVOSIndex(**D.INDEX_KW), "seq00",
                                 meta, D.jax.random.PRNGKey(D.KEY))
        return np.asarray(res["probs"]), time.perf_counter() - t0

    def run_port(pair, fused, draws=True, **kw):
        _, ev = D.evaluators(pair, fused, **kw)
        if draws:
            ev.sample_draws = D.object_draws(
                pair, D.jax.random.PRNGKey(D.KEY), D.SEED, ev.cfg)[0]
        return ev.eval_sequence(D.SyntheticVOSIndex(**D.INDEX_KW), "seq00",
                                pair["meta"], D.SEED)["probs"].numpy()

    base = D.make_pair()
    for fused in (False, True):
        loop = "fused" if fused else "host"
        j_ev, _ = D.evaluators(base, fused)
        want, secs = run_jax(j_ev, base["variables"], base)
        out(loop=loop, side="jax", seconds=secs)
        for s in (1 + 1e-6, 1 - 1e-6, 1 + 3e-6, 1 - 3e-6):
            p, _ = run_jax(j_ev, _scaled(base["variables"], s), base)
            out(loop=loop, side="jax", scale=s,
                prob_spread=float(np.abs(p - want).max()))
        got = run_port(base, fused)
        out(loop=loop, side="port batched vs jax",
            prob_diff=float(np.abs(got - want).max()),
            mean_diff=float(np.abs(got - want).mean()))
        own = run_port(base, fused, draws=False)
        in_turn = run_port(base, fused, draws=False, batch_objects=False)
        out(loop=loop, side="port batched vs port loop",
            prob_diff=float(np.abs(own - in_turn).max()))
        for s in (1 + 1e-6, 1 - 1e-6):
            scaled = dict(base)
            scaled["meta"] = base["meta"]._replace(model_init={
                k: v * np.float32(s)
                for k, v in base["meta"].model_init.items()})
            p = run_port(scaled, fused, draws=False, batch_objects=False)
            out(loop=loop, side="port loop", scale=s,
                prob_spread=float(np.abs(p - in_turn).max()))


def detection_stream():
    import jax
    import numpy as np

    import test_torch_port_detection_entry as E

    pair = E.make_pair()
    j_ev, ev = E._evaluators(pair)
    key, seed = jax.random.PRNGKey(11), 9
    kw = dict(E.INDEX_KW, num_sequences=4)
    j_index, index = E.JSyntheticVOSIndex(**kw), E.SyntheticVOSIndex(**kw)

    def jax_rows(names, s):
        meta = pair["j_meta"]._replace(
            model_init=_scaled(pair["variables"], s))
        return j_ev.eval_stream(j_index, names, meta, key)

    for names in (["seq00", "seq01"], ["seq01", "seq00"],
                  ["seq02", "seq03"], ["seq03", "seq02"]):
        want = jax_rows(names, 1.0)
        moved = {n: 0 for n in names}
        for s in (1 + 1e-6, 1 - 1e-6):
            got = jax_rows(names, s)
            for n in names:
                moved[n] = max(moved[n], int((got[n] != want[n]).sum()))
        ev.sample_draws = E.draws_by_seed({
            E.fold_in(E.fold_in(seed, i), 0): E.JaxDraws(
                pair["jmodel"], pair["variables"],
                jax.random.fold_in(jax.random.fold_in(key, i), 0), ev.cfg)
            for i in range(len(names))})
        port = ev.eval_stream(index, names, pair["meta"], seed)
        for i, n in enumerate(names):
            out(seq=n, position=i, jax_pixels_moved_by_1e6=moved[n],
                port_vs_jax_pixels=int((port[n] != want[n]).sum()))


def detection_meta():
    import jax
    import numpy as np

    import test_torch_port_detection_meta as M

    jmodel, variables, _ = M.tiny_pair()
    rng = np.random.RandomState(4)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(M.j_init_lr_tree(variables["params"], "neuron")))
    cfg = M.JMetaStepConfig(remat=False, augment=M.JAugmentConfig(**M.AUG),
                            num_epochs=2, bptt_epochs=2, train_batch_size=2)
    mesh = M.make_mesh(num_tasks=1, devices=jax.devices()[:1])
    step = M.j_make_meta_step(
        jmodel.apply, M.JMetaOptimConfig(use_log_init_lr=False), cfg,
        M.JOuterOptimConfig(), mesh, meta_batch_size=M.TASKS,
        task_fns=M.j_detection_task_fns(jmodel, cfg))
    for seed in range(4):
        for s in (1.0, 1 + 1e-6, 1 - 1e-6):
            meta = M.JMetaParams(model_init=_scaled(variables, s),
                                 log_init_lr={"params": lrs})
            tasks = M.JMetaTaskset([M.JSyntheticVOSIndex(**M.INDEX_KW)],
                                   M.JTasksetCfg(crop_size=(M.SIZE, M.SIZE)),
                                   seed=seed)
            o = step(meta, step.init(meta),
                     M.shard_task_batch(mesh, tasks.sample_batch(M.TASKS)))
            out(task_seed=seed, scale=s,
                per_task_loss=np.asarray(o.per_task_loss).tolist())


def detection_parent():
    import jax

    import test_torch_port_parent_trainer as P

    size = (P.DET_SIZE, P.DET_SIZE)
    kw = dict(P.CASES["detection_adam"], max_objects=2, loss_func="dice",
              batch_size=2, weight_decay=1e-2, crop_size=size, seed=3,
              log_interval=100, snapshot_interval=100)
    for seed in range(3):
        for s in (1.0, 1 + 1e-6, 1 - 1e-6):
            jmodel, variables, _ = P.tiny_pair()
            sampler = P.JInstanceFrameSampler(
                [P._index(P.JSyntheticVOSIndex, size, num_objects=2, seed=6)],
                size, max_objects=2, seed=seed)
            trainer = P.JParentTrainer(
                jmodel.apply, _scaled(variables, s), sampler,
                P.JParentTrainConfig(augment=P.JAugmentConfig(**P.MILD),
                                     **kw),
                mesh=P.make_mesh(num_tasks=1, devices=jax.devices()[:1]),
                logger=P.JMetricsLogger(echo=False))
            out(sampler_seed=seed, scale=s,
                losses=[trainer.run(1)["loss"] for _ in range(3)])


def parent_border():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_port_parent_trainer as P
    from e_osvos_tpu.data import transforms as jt
    from e_osvos_torch.data import transforms as tt
    from e_osvos_torch.models import functional_apply
    from e_osvos_torch.ops import losses as tl

    zoom_out = dict(scale_min=0.9, scale_max=1.1, rot_deg=10.0,
                    brightness=0.05, contrast=0.05, saturation=0.05,
                    flip_prob=0.5, compute_dtype="float32")
    jcfg, cfg = jt.AugmentConfig(**zoom_out), tt.AugmentConfig(**zoom_out)
    jmodel, variables, model = P.dense_setup()
    sampler = P.FrameSampler([P._index(P.SyntheticVOSIndex, P.DENSE_SIZE,
                                       seed=6)], P.DENSE_SIZE, seed=0)
    imgs, labels, seeds = sampler.sample_batch(2)
    j_aug = [jt.augment_frame(jax.random.PRNGKey(s), jnp.asarray(i),
                              jnp.asarray(l), jcfg)
             for s, i, l in zip(seeds, imgs, labels)]
    p_aug = [tt.augment_frame(torch.from_numpy(i), torch.from_numpy(l),
                              P.jax_frame_draws(jax.random.PRNGKey(s), jcfg),
                              cfg) for s, i, l in zip(seeds, imgs, labels)]

    def grads(batch):
        x = tt.normalize(torch.stack([b[0] for b in batch]), "davis")
        y = torch.stack([b[1] for b in batch])
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in model.state_dict().items()}
        valid = y != 255
        loss = tl.compute_loss("cross_entropy_and_dice",
                               functional_apply(model)(params, x)[..., 0],
                               torch.where(valid, y, 0).float(), valid)
        return dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))

    g_port = grads(p_aug)
    g_jax_frames = grads([(torch.tensor(np.asarray(i)),
                           torch.tensor(np.asarray(l))) for i, l in j_aug])
    out(image_diff=max(float((a[0] - torch.tensor(np.asarray(b[0]))).abs()
                             .max()) for a, b in zip(p_aug, j_aug)),
        label_mismatches=sum(int((a[1] != torch.tensor(np.asarray(b[1])))
                                 .sum()) for a, b in zip(p_aug, j_aug)))
    for k in ("backbone.stem_conv.weight", "backbone.stem_norm.scale"):
        out(tensor=k, grad_rel_diff=float(
            (g_port[k] - g_jax_frames[k]).abs().max()
            / g_jax_frames[k].abs().max()))


def small_meta():
    import chip_smoke as C

    for seed in C.DET_META_SEEDS:
        step, (loss, grads, _), _, _, names = C.small_detection_meta_step(
            "cpu", seed=seed)
        _, (p_loss, p_grads, _), _, _, _ = C.small_detection_meta_step(
            "cpu", draws_from=step, perturb=1e-6, seed=seed)
        rest, head, _, worst = C.head_split_excess(
            names, [g for d in p_grads for g in d.values()],
            [g for d in grads for g in d.values()])
        out(task_seed=seed,
            loss_rel=abs(float(p_loss) - float(loss)) / abs(float(loss)),
            over_outside_mask_head=rest, over_in_mask_head=head,
            worst_of_limit=worst)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["slice", "detection-batched",
                                     "detection-stream",
                                     "detection-meta", "detection-parent",
                                     "parent-border", "small-meta"])
    ap.add_argument("--threads", type=int, default=0,
                    help="XLA and torch intra-op threads (0: default)")
    args = ap.parse_args()
    if args.threads:
        os.environ["XLA_FLAGS"] = (
            "--xla_cpu_multi_thread_eigen=false "
            f"intra_op_parallelism_threads={args.threads}")
        import torch

        torch.set_num_threads(args.threads)
    {"slice": slice_spread, "detection-batched": detection_batched,
     "detection-stream": detection_stream,
     "detection-meta": detection_meta,
     "detection-parent": detection_parent, "parent-border": parent_border,
     "small-meta": small_meta}[args.what]()


if __name__ == "__main__":
    main()
