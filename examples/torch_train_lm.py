"""End-to-end training driver (PyTorch port).

Default: a ~100M-param llama-family model for 200 steps on ``--device``
(reduce with --small for CI).  Demonstrates the full production path:
config -> train step (flash attention forward and backward kernels on a
card) -> checkpointed fault-tolerant loop -> resume.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
      PYTHONPATH=src python examples/torch_train_lm.py --small --steps 30 --device cpu
"""
import argparse
import logging
import tempfile

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.train.loop import LoopConfig, train


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000)


def model_small() -> ModelConfig:
    return ModelConfig(
        name="llama-5m", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_small() if args.small else model_100m()
    rc = RunConfig(
        seq_len=args.seq or (128 if args.small else 512),
        global_batch=args.batch or (8 if args.small else 16),
        kind="train", remat=False, q_block=128, kv_block=128, lr=6e-4)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 5, 1),
                      ckpt_dir=args.ckpt or tempfile.mkdtemp(prefix="train_lm_"))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    hist = train(cfg, rc, loop, device=args.device, log_every=10)
    print(f"\nfinal loss {hist['loss'][-1]:.4f} "
          f"(from {hist['loss'][0]:.4f}); "
          f"median step {sorted(hist['step_time'])[len(hist['step_time'])//2]:.2f}s")
    return hist


if __name__ == "__main__":
    main()
