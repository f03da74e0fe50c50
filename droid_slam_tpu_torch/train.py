"""Train DroidNet with the PyTorch/CUDA port on one GPU.

Unrolled update iterations with two differentiable BA solves per step,
geodesic + residual + flow losses, one-cycle AdamW, periodic full-state
checkpoints.  Only the synthetic curriculum is available as a data source.

Example:
  python -m droid_slam_tpu_torch.train --synthetic --steps 200
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--name", default="droid_torch")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated textured box and plane scenes")
    p.add_argument("--scenes", type=int, default=96,
                   help="number of synthetic scenes to render")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--ckpt", default=None, help="checkpoint file to resume")
    p.add_argument("--init_npz", default=None,
                   help="warm-start params from an exported weights npz "
                        "(fresh optimizer)")
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
    p.add_argument("--edges", type=int, default=24)
    p.add_argument("--image_size", type=int, nargs=2, default=(384, 512))
    p.add_argument("--fix_scale", action="store_true")
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--ckpt_dir", default="checkpoints")
    args = p.parse_args(argv)

    if not args.synthetic:
        p.error("only --synthetic training is available (the TartanAir "
                "reader is not part of this package yet)")

    from .config import TrainConfig
    from .data.synthetic import SyntheticCurriculum
    from .models.convert import save_npz_weights
    from .training.trainer import train

    cfg = TrainConfig(
        name=args.name, lr=args.lr, steps=args.steps, batch=args.batch,
        iters=args.iters, clip=args.clip, n_frames=args.n_frames,
        edges=args.edges, image_size=tuple(args.image_size),
        fix_scale=args.fix_scale, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
    )
    dataset = SyntheticCurriculum(cfg, n_scenes=args.scenes)
    print(f"training on {len(dataset)} synthetic scenes", flush=True)
    state = train(cfg, dataset, device=args.device, max_steps=args.steps,
                  resume=args.ckpt, init_npz=args.init_npz,
                  start_step=args.start_step, lookup_impl=args.lookup_impl)
    if args.export_npz:
        save_npz_weights(state.net, args.export_npz)


if __name__ == "__main__":
    main()
