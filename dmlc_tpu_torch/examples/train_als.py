"""End-to-end matrix factorization (ALS) on the warm, shuffled block cache
and fed by the data service.

The port of the repository's ``examples/train_als.py``:

1. the ratings corpus is plain libsvm (label = user id, features =
   ``item:rating`` pairs), parsed by the port's libsvm parser;
2. the parser runs behind the pod-sharded block cache with the epoch plan
   (``block_cache=`` + ``shuffle_seed=0`` + ``pod_sharding=True``): epoch 0
   parses the text once and publishes the blocks, every later epoch reads
   them back in a seeded order, and each host of a job draws a disjoint
   set of user rows;
3. batches flow through ``DeviceIter`` in the ELL layout over the mesh's
   data axis into ``AlsLearner``, whose step solves the batch's users and
   scatters the item side's normal equations, solved once an epoch;
4. a mid-training checkpoint of a warm epoch, restored into fresh objects,
   replays the loss tail byte for byte;
5. the same model trains fed by the data service
   (:mod:`dmlc_tpu_torch.service`): the factorization job registers on a
   ``LocalFleet`` beside a second tenant, over one ``share_dir``, so each
   part parses once fleet-wide, the tenant drains warm, nothing gives up,
   and a mid-train checkpoint on this path replays byte for byte.

    python -m dmlc_tpu_torch.examples.train_als [--dryrun] [--device cpu]

``--dryrun`` is the small configuration (128 users, 24 items, 2 factors).
Without ``--device`` it runs on the card and raises ``DMLCError`` on a
host without one. Under the DMLC_* contract (``dmlc-submit``, or
``dmlc_tpu_torch.parallel.launch.run_local``) ``pod_sharding=True``
resolves each rank's shard from ``DMLC_TASK_ID`` / ``DMLC_NUM_WORKER``;
the ranks' shards may differ by a block, and the example does not yet
agree on a common step count over them, so it runs on one rank.
"""

from __future__ import annotations

import argparse
import os
import tempfile

FULL = {"users": 4096, "items": 512, "factors": 16, "per_row": 32, "batch": 512,
        "reg": 0.05, "epochs": 4, "restore_at": 2, "chunk_bytes": 64 << 10}
DRYRUN = {"users": 128, "items": 24, "factors": 2, "per_row": 8, "batch": 16,
          "reg": 0.05, "epochs": 3, "restore_at": 3, "chunk_bytes": 1 << 10}


def synthesize(path: str, num_users: int, num_items: int, per_row: int,
               rank: int = 4, seed: int = 0) -> None:
    """Low-rank ratings corpus: one libsvm row per user, label = user id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gt_u = rng.normal(size=(num_users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(num_items, rank)).astype(np.float32)
    with open(path, "w") as f:
        for uid in range(num_users):
            items = rng.choice(num_items, size=per_row, replace=False)
            ratings = gt_u[uid] @ gt_v[items].T
            feats = " ".join(f"{j}:{r:.6f}" for j, r in zip(items, ratings))
            f.write(f"{uid} {feats}\n")


def _build(path, cache_dir, cfg, mesh, device=None):
    """(model, DeviceIter) over the pod-sharded warm block cache."""
    from dmlc_tpu_torch.data import DeviceIter, create_parser
    from dmlc_tpu_torch.models import AlsLearner

    model = AlsLearner(cfg["users"], cfg["items"], num_factors=cfg["factors"],
                       reg=cfg["reg"], seed=0, mesh=mesh, device=device)
    # blocks smaller than one batch: every batch crosses a block boundary,
    # so a mid-epoch checkpoint carries a seekable epoch-plan source state
    # (kind='source') instead of a count to replay
    parser = create_parser(path, 0, 1, "libsvm", block_cache=cache_dir, shuffle_seed=0,
                           pod_sharding=True, chunk_bytes=cfg["chunk_bytes"])
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=cfg["batch"],
                    layout="ell", max_nnz=cfg["per_row"], mesh=mesh,
                    shardings=model.batch_shardings(), drop_remainder=True, device=device)
    return model, it


def restore_check(path, cache_dir, cfg, mesh, device=None) -> int:
    """A mid-training checkpoint must replay the loss trajectory byte for
    byte: run A records a warm epoch's step losses and checkpoints (model,
    iterator) mid-epoch; run B restores into fresh objects and replays the
    tail. Returns the number of compared steps."""
    import numpy as np

    from dmlc_tpu_torch.models._loop import host_scalar

    model, it = _build(path, cache_dir, cfg, mesh, device)
    model.fit_epoch(it)  # epoch 0 of this pipeline
    losses_a, ckpt, n = [], None, 0
    for batch in it:
        losses_a.append(np.float32(host_scalar(model.step(batch))))
        n += 1
        if ckpt is None and n == cfg["restore_at"]:
            ckpt = (model.state_dict(), it.state_dict())
    it.reset()
    it.close()
    assert ckpt is not None, "corpus too small for the restore point"
    # a seekable mid-epoch position in the permuted warm stream, not a
    # count to replay
    assert ckpt[1]["kind"] == "source", ckpt[1]

    model2, it2 = _build(path, cache_dir, cfg, mesh, device)
    model2.load_state_dict(ckpt[0])
    it2.load_state(ckpt[1])
    losses_b = [np.float32(host_scalar(model2.step(b))) for b in it2]
    it2.close()
    tail = np.asarray(losses_a[cfg["restore_at"]:])
    replay = np.asarray(losses_b)
    assert tail.tobytes() == replay.tobytes(), f"restore diverged: {tail[:4]} vs {replay[:4]}"
    return len(replay)


def service_leg(path, cfg, mesh, device=None) -> dict:
    """Train the same model fed by the data service, beside a second tenant.

    The factorization job and the tenant share one fleet over one
    ``share_dir``: epoch 0 parses each part once on the workers, the
    tenant's drain and every later epoch resolve to the shared artifacts,
    and nothing gives up. A mid-train checkpoint on this path replays byte
    for byte (a count replay: service blocks carry no seekable source
    annotation, so the restore re-pulls and drops the prefix)."""
    import numpy as np

    from dmlc_tpu_torch.data import DeviceIter
    from dmlc_tpu_torch.io import resilience
    from dmlc_tpu_torch.models import AlsLearner
    from dmlc_tpu_torch.models._loop import host_scalar
    from dmlc_tpu_torch.service import LocalFleet, ServiceParser

    pcfg = {"format": "libsvm"}
    num_parts = 2
    base = resilience.counters_snapshot()

    def learner():
        return AlsLearner(cfg["users"], cfg["items"], num_factors=cfg["factors"],
                          reg=cfg["reg"], seed=0, mesh=mesh, device=device)

    with tempfile.TemporaryDirectory(prefix="dmlc-als-share-") as share:
        fleet = LocalFleet(None, 0, num_workers=2, parser=pcfg, share_dir=share)
        try:
            fleet.register_job("als", path, num_parts, parser=pcfg)

            def train_pass(model, record=None, restore=None):
                it = DeviceIter(ServiceParser(fleet.address, job="als"),
                                num_col=model.device_num_col(), batch_size=cfg["batch"],
                                layout="ell", max_nnz=cfg["per_row"], mesh=mesh,
                                shardings=model.batch_shardings(), drop_remainder=True,
                                device=device)
                try:
                    if restore is not None:
                        it.load_state(restore)
                    losses, ckpt = [], None
                    for batch in it:
                        losses.append(np.float32(host_scalar(model.step(batch))))
                        if record is not None and ckpt is None and len(losses) == record:
                            ckpt = (model.state_dict(), it.state_dict())
                    model.finalize_items()
                finally:
                    it.close()
                return losses, ckpt

            model = learner()
            train_pass(model)  # epoch 0: the workers parse each part once
            # the second tenant joins after the parse: its whole drain
            # resolves to the shared artifacts
            fleet.register_job("tenant-b", path, num_parts, parser=pcfg)
            tb = ServiceParser(fleet.address, job="tenant-b")
            tenant_blocks = 0
            while tb.next_block() is not None:
                tenant_blocks += 1
            tb.close()
            # a warm epoch with a mid-train checkpoint, replayed from fresh objects
            losses_a, ckpt = train_pass(model, record=cfg["restore_at"])
            model2 = learner()
            model2.load_state_dict(ckpt[0])
            losses_b, _ = train_pass(model2, restore=ckpt[1])
            tail = np.asarray(losses_a[cfg["restore_at"]:])
            replay = np.asarray(losses_b)
            assert tail.tobytes() == replay.tobytes(), (
                f"service-fed restore diverged: {tail[:4]} vs {replay[:4]}")
        finally:
            fleet.close()
    res = resilience.counters_delta(base)
    assert res.get("service_giveups", 0) == 0, res
    parsed = res.get("service_parts_parsed", 0)
    shared = res.get("service_parts_shared", 0)
    assert parsed <= num_parts, f"parse-once violated: {parsed} parses of {num_parts} parts"
    return {"tenant_blocks": tenant_blocks, "parts_parsed": parsed,
            "parts_shared": shared, "service_loss": float(losses_a[-1]),
            "replayed_steps": len(replay)}


def config(dryrun: bool, world: int) -> dict:
    """The run's configuration: the global batch divides over the ranks,
    and the users divide into whole batches, so ``drop_remainder`` loses
    nothing."""
    cfg = dict(DRYRUN if dryrun else FULL)
    cfg["batch"] = max(cfg["batch"], world)
    cfg["users"] -= cfg["users"] % cfg["batch"]
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device of every rank (default: the card)")
    args = ap.parse_args(argv)

    from dmlc_tpu_torch.parallel import init_from_env, make_mesh

    init_from_env(device=args.device)  # no-op for one worker
    mesh = make_mesh(devices=args.device)
    cfg = config(args.dryrun, mesh.size)
    with tempfile.TemporaryDirectory(prefix="dmlc-als-") as workdir:
        path = os.path.join(workdir, "ratings.libsvm")
        synthesize(path, cfg["users"], cfg["items"], cfg["per_row"])

        # ---- local path: pod-sharded warm block cache ----
        cache_dir = os.path.join(workdir, "cache")
        model, it = _build(path, cache_dir, cfg, mesh, args.device)

        def log(epoch, loss, nb, secs):
            st = it.stats()
            print(f"epoch {epoch}: loss={loss:.5f} batches={nb} {secs:.2f}s "
                  f"cache={st.get('cache_state')} "
                  f"input_wait={st.get('input_wait_seconds', 0.0):.2f}s", flush=True)

        model.fit(it, epochs=cfg["epochs"], log_fn=log)
        print(f"eval mse (local path): {model.eval_loss(it):.6f}", flush=True)
        it.close()

        # ---- mid-train checkpoint/restore byte-identity, warm cache ----
        steps = restore_check(path, cache_dir, cfg, mesh, args.device)
        print(f"checkpoint/restore byte-identical over {steps} steps", flush=True)

        # ---- service path: the ALS job and a second tenant on one fleet ----
        svc = service_leg(path, cfg, mesh, args.device)
        print(f"service-fed: loss={svc['service_loss']:.5f} "
              f"tenant_blocks={svc['tenant_blocks']} "
              f"parts parsed={svc['parts_parsed']} shared={svc['parts_shared']} "
              f"giveups=0", flush=True)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
