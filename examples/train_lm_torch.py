"""End-to-end LM training on the port, with atomic, hash-verified
checkpoints (the PyTorch twin of `examples/train_lm.py`).

Trains a small model (default ~10M params) for a few hundred steps on
the synthetic sharded `TokenStream`, checkpointing through the port's
`repro_torch.checkpoint` facade (the snapshot codec of the engine's
durability layer), then restores the latest checkpoint and checks it
bit for bit.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
      (on the CUDA card; --device cpu runs the plain PyTorch path)
"""
import argparse
import os
import tempfile
import time
from dataclasses import replace

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.models import lm
from repro_torch.train import adamw_init, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "slsm_train_ckpt_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = replace(get_config("deepseek-7b"),
                  n_layers=args.layers, d_model=args.d_model,
                  n_heads=max(4, args.d_model // 32),
                  n_kv=max(2, args.d_model // 64),
                  d_ff=args.d_model * 4, vocab=8192, dtype="float32")
    model = lm.init_params(cfg, 0, device=args.device)
    print(f"training {cfg.name}-derived model on {model.device}: "
          f"{lm.param_count(model):,} params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    opt = adamw_init(model)
    step_fn = make_train_step(cfg, base_lr=1e-3, warmup=20,
                              total_steps=args.steps)
    stream = iter(TokenStream(cfg.vocab, args.batch, args.seq, seed=0))
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, "full"), keep_last=2)

    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        model, opt, m = step_fn(model, opt, next(stream))
        if step % 20 == 0 or step == 1:
            loss = float(m["loss"])      # waits for the step
            dt = time.perf_counter() - t0
            tok_s = step * args.batch * args.seq / dt
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  {tok_s:,.0f} tok/s")
            if not torch.isfinite(m["loss"]):
                raise SystemExit(f"loss not finite at step {step}")
        if step % args.ckpt_every == 0:
            params = dict(model.named_parameters())
            path = mgr.save(step, params, blocking=False)  # atomic full
            print(f"  ckpt @ {step}: async save -> {path}")
    mgr.wait()

    # restart drill: restore the latest full checkpoint, verify
    params = dict(model.named_parameters())
    restored, at = mgr.restore(params, device=model.device)
    print(f"restore drill: loaded step {at}")
    diff = max(float((a.float() - restored[k].float()).abs().max())
               for k, a in params.items())
    same = all(torch.equal(a, restored[k]) for k, a in params.items())
    print(f"restore drill: max |param diff| = {diff:.2e} (exact bitwise "
          f"restore expected: {'OK' if same else 'MISMATCH'})")
    if at != args.steps - args.steps % args.ckpt_every or not same:
        raise SystemExit("restore drill failed")


if __name__ == "__main__":
    main()
