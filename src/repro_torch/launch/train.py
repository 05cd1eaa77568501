"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train``: the reduced config by default, the full one
with ``--full-size``, on the card (``--device cuda``, the default, raises
without CUDA; ``--device cpu`` asks for the CPU). With ``--predict``,
DNNAbacus admission control estimates the step time and peak memory of the
requested job *before* anything is allocated, refuses a job predicted to
run out of the service's memory budget (exit code 2), and hands the
predicted step time to the straggler detector: the paper's scheduling
application wired into the launcher.

With ``--data`` x ``--model-par`` above 1 the job trains on a
``("data", "model")`` mesh (``launch.mesh.make_host_mesh``, clamped to the
world as the reference clamps to its devices) with the model's sharder, as
DTensors: under ``torchrun --nproc-per-node N`` over the launched world, and
in a lone process over a one-rank world, where the mesh is (1, 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--data", type=int, default=1, help="data-parallel axis")
    ap.add_argument("--model-par", type=int, default=1, help="model axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--predict", action="store_true",
                    help="DNNAbacus admission control before launch")
    ap.add_argument("--predictor-path", default="artifacts/abacus")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the job runs: cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, card_unless_asked
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import LoopConfig, Trainer

    device = card_unless_asked(args.device, "pass --device cpu")
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced_config(cfg)
    mesh = (make_host_mesh(args.data, args.model_par, device=device)
            if args.data * args.model_par > 1 else None)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    predicted = None
    if args.predict:
        from repro_torch.core.predictor import DNNAbacus
        if os.path.exists(args.predictor_path + ".json"):
            service = DNNAbacus.load(args.predictor_path).service()
            est = service.predict_one(cfg, args.batch, args.seq)
            predicted = est["time_s"]
            print(f"[abacus] predicted step time {est['time_s']*1e3:.1f} ms, "
                  f"peak memory {est['memory_bytes']/2**30:.2f} GiB", flush=True)
            budget = est["hbm_budget"]
            if est["memory_bytes"] > budget:
                print("[abacus] REFUSED: predicted OOM "
                      f"({est['memory_bytes']/2**30:.1f} GiB > "
                      f"{budget/2**30:.1f} GiB)", file=sys.stderr)
                return 2
        else:
            print("[abacus] no fitted predictor found; fit one and save it "
                  "(DNNAbacus.save) at --predictor-path first", file=sys.stderr)

    model = build_model(cfg, device=device, sharder=shd.make_sharder(mesh))
    loop_cfg = LoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                          ckpt_dir=args.ckpt_dir, accum=args.accum,
                          zero=not args.no_zero,
                          predicted_step_s=predicted)
    trainer = Trainer(model, opt_lib.OptConfig(), loop_cfg, mesh=mesh)
    log = trainer.run()
    if mesh is not None and mesh.get_rank() != 0:
        return 0  # rank 0 reports for the job
    if mesh is not None:
        print(f"[mesh] {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} rank(s) on {mesh.device_type}", flush=True)
    for rec in log:
        print(json.dumps(rec))
    if args.log:
        trainer.write_log(args.log)
    print(f"final loss: {log[-1]['loss']:.4f} "
          f"(retries={trainer.runner.retries}, "
          f"stragglers={trainer.runner.stragglers})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
