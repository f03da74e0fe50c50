"""Train DroidNet with the PyTorch/CUDA port on one GPU.

TartanAir frame-graph sampling (or the synthetic curriculum), unrolled
update iterations with two differentiable BA solves per step, geodesic +
residual + flow losses, one-cycle AdamW, periodic full-state checkpoints.
The last line printed is a JSON summary: samples, the dataset's set-up
seconds (the covisibility graphs on a first run), training seconds, steps
and, on the card, the lookup kernels' launches and peak memory.

Examples:
  python -m droid_slam_tpu_torch.train --datapath datasets/TartanAir \\
      --steps 250000
  python -m droid_slam_tpu_torch.train --synthetic --steps 200
"""

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--name", default="droid_torch")
    p.add_argument("--datapath", default=None, help="TartanAir root")
    p.add_argument("--cache_dir", default=None,
                   help="where the TartanAir scene index is cached "
                        "(default: droid_slam_tpu_torch/data/cache)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated textured box and plane scenes")
    p.add_argument("--scenes", type=int, default=96,
                   help="number of synthetic scenes to render")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--ckpt", default=None, help="checkpoint file to resume")
    p.add_argument("--init_npz", default=None,
                   help="warm-start params from a weights file: an .npz, "
                        "or the reference's droid.pth (fresh optimizer)")
    p.add_argument("--start_step", type=int, default=None,
                   help="provenance step label for --init_npz runs")
    p.add_argument("--export_npz", default=None,
                   help="write the final weights as an npz")
    p.add_argument("--lookup_impl", default="level",
                   choices=("level", "level_v2"))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=250000)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--clip", type=float, default=2.5)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--n_frames", type=int, default=7)
    p.add_argument("--fmin", type=float, default=8.0)
    p.add_argument("--fmax", type=float, default=96.0)
    p.add_argument("--edges", type=int, default=24)
    p.add_argument("--image_size", type=int, nargs=2, default=(384, 512))
    p.add_argument("--fix_scale", action="store_true")
    p.add_argument("--log_every", type=int, default=10,
                   help="print and log the metrics every N steps")
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--ckpt_dir", default="checkpoints")
    args = p.parse_args(argv)

    if not args.synthetic and args.datapath is None:
        p.error("provide --datapath or --synthetic")

    import torch

    from .config import TrainConfig
    from .models.convert import save_npz_weights
    from .ops import corr
    from .runtime.slam import resolve_device
    from .training.trainer import train

    device = resolve_device(args.device)
    cfg = TrainConfig(
        name=args.name, lr=args.lr, steps=args.steps, batch=args.batch,
        iters=args.iters, clip=args.clip, n_frames=args.n_frames,
        fmin=args.fmin, fmax=args.fmax, edges=args.edges,
        image_size=tuple(args.image_size), fix_scale=args.fix_scale,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
    )
    t = time.time()
    if args.synthetic:
        from .data.synthetic import SyntheticCurriculum
        dataset = SyntheticCurriculum(cfg, n_scenes=args.scenes)
    else:
        from .data.tartan import TartanAir
        dataset = TartanAir(args.datapath, n_frames=cfg.n_frames,
                            crop_size=cfg.image_size, fmin=cfg.fmin,
                            fmax=cfg.fmax, cache_dir=args.cache_dir,
                            device=device)
    dataset_s = time.time() - t
    print(f"training on {len(dataset)} "
          f"{'synthetic scenes' if args.synthetic else 'samples'}",
          flush=True)
    if len(dataset) == 0:
        print("no training samples found", file=sys.stderr)
        return 1

    corr.reset_launch_counts()
    t = time.time()
    state = train(cfg, dataset, device=device, max_steps=args.steps,
                  log_every=args.log_every, resume=args.ckpt,
                  init_npz=args.init_npz, start_step=args.start_step,
                  lookup_impl=args.lookup_impl)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t
    if args.export_npz:
        save_npz_weights(state.net, args.export_npz)

    summary = dict(device=str(device), samples=len(dataset),
                   dataset_s=dataset_s, train_s=train_s, steps=state.step)
    if device.type == "cuda":
        summary.update(launches=corr.launch_counts(),
                       peak_mem_bytes=torch.cuda.max_memory_allocated(device))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
