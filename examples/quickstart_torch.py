"""Quickstart on the PyTorch port: the three layers of the framework in one
script, on the CUDA card (``--device cpu`` asks for the CPU).

1. profile a few training configurations (the paper's §2 rig);
2. fit DNNAbacus and predict cost for an unseen configuration (§3);
3. train a reduced assigned architecture for a few steps with the
   production Trainer (checkpointed, fault-tolerant).

On the CPU, step 1 measures the host (``profile_zoo_on_host``: wall-clock
time, and the traced program's peak live bytes for memory).

    PYTHONPATH=src python examples/quickstart_torch.py
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.automl.models import (GradientBoostingRegressor,
                                            RandomForestRegressor, RidgeRegressor)
from repro_torch.core.predictor import DNNAbacus
from repro_torch.core.profiler import profile_zoo, profile_zoo_on_host
from repro_torch.models import build_model, card_unless_asked
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    device = card_unless_asked(ap.parse_args().device, "pass --device cpu")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    def profile(net, batch):
        if device.type == "cuda":
            return profile_zoo(net, batch=batch, steps=2, device=device)
        return profile_zoo_on_host(net, batch=batch, steps=2)

    # 1. profile -------------------------------------------------------
    print("== profiling a few CNN training configs ==")
    records = []
    for net in ("lenet5", "squeezenet", "nin"):
        for batch in (8, 16, 32):
            r = profile(net, batch)
            records.append(r)
            print(f"  {net:12s} b={batch:3d}  {r.time_s*1e3:8.1f} ms  "
                  f"{r.mem_bytes/2**20:8.1f} MiB")

    # 2. fit + predict --------------------------------------------------
    print("== fitting DNNAbacus ==")
    fac = lambda seed: [RandomForestRegressor(n_trees=25, seed=seed),
                        GradientBoostingRegressor(n_stages=100, seed=seed),
                        RidgeRegressor()]
    abacus = DNNAbacus().fit(records, candidate_factory=fac)
    probe = profile("squeezenet", 24)  # unseen batch
    t_pred, m_pred = abacus.predict([probe])
    print(f"  unseen config: predicted {t_pred[0]*1e3:.1f} ms "
          f"(measured {probe.time_s*1e3:.1f} ms), "
          f"{m_pred[0]/2**20:.1f} MiB (measured {probe.mem_bytes/2**20:.1f})")

    # 3. train an assigned arch (reduced) --------------------------------
    print("== training reduced qwen2-0.5b for 10 steps ==")
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, device=device)
    trainer = Trainer(model, opt_lib.OptConfig(),
                      LoopConfig(steps=10, batch=4, seq=64, log_every=3))
    log = trainer.run()
    for rec in log:
        print(f"  step {rec['step']:3d} loss {rec['loss']:.4f}")
    print("done.")


if __name__ == "__main__":
    main()
