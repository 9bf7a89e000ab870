"""Command-line interface: ``python -m bio_image_unet_tpu_torch <command>``
(counterpart of ``bio_image_unet_tpu/__main__.py``, with the same argv,
defaults and flow, driving the port's five facades).

Commands:
  train    DataProcess + Trainer for any family (unet | siam_unet | unet3d |
           multi_output_unet | multi_output_unet3d); the best checkpoint is
           ``<workdir>/model/model.ckpt``
  predict  tiled inference with any family checkpoint (``.ckpt`` or ``.pt``;
           the family is read from the checkpoint unless ``--family`` names it)
  devices  list the visible CUDA devices; exit code 1 when there is none

``train`` and ``predict`` run on the card (``--device cuda``, the default)
and fail when there is none; ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import sys

FAMILIES = ["unet", "siam_unet", "unet3d", "multi_output_unet", "multi_output_unet3d"]


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the card; fails when there is none)")


def _add_train(sub):
    p = sub.add_parser("train", help="prepare data and train a model")
    p.add_argument("--family", default="unet", choices=FAMILIES)
    p.add_argument("--image-dir", required=True,
                   help="image (2D families) or volume (3D families) dir")
    p.add_argument("--label-dir",
                   help="mask dir (single-head families)")
    p.add_argument("--target-dir", action="append",
                   help="(multi_output families) a target dir; repeat per "
                        "head, the head name is the dir basename")
    p.add_argument("--heads-json",
                   help="(multi_output families) output_heads config as "
                        "inline JSON or a path to a .json file; default: one "
                        "sigmoid/BCEDiceLoss head per --target-dir "
                        "('orientation' dirs get a 2-channel "
                        "WeightedVectorFieldLoss head)")
    p.add_argument("--network", default=None,
                   help="override the family's default model class")
    p.add_argument("--deep-supervision", action="store_true",
                   help="(multi_output_unet) per-level supervised losses")
    p.add_argument("--workdir", default="./run")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-filter", type=int, default=32)
    p.add_argument("--dim", type=int, nargs="+", default=[256, 256],
                   help="tile size (2 ints; 3 for unet3d)")
    p.add_argument("--aug-factor", type=int, default=10)
    p.add_argument("--loss", default="BCEDice")
    p.add_argument("--mode", default="max",
                   help="siamese join mode (siam_unet only)")
    p.add_argument("--device-cache", action="store_true",
                   help="training tiles resident on the card")
    p.add_argument("--half-precision", action="store_true")
    p.add_argument("--device-augment", action="store_true")
    p.add_argument("--resume", action="store_true")
    _add_device(p)


_MODEL_FAMILY = {
    "Unet": "unet", "AttentionUnet": "unet", "Unet_v0": "unet",
    "BabyUnet": "unet", "Siam_UNet": "siam_unet", "UNet3D": "unet3d",
    "MultiOutputUnet": "multi_output_unet",
    "MultiOutputNestedUNet": "multi_output_unet",
    "MultiOutputNestedUNet_3Levels": "multi_output_unet",
    "MultiOutputUnet3D": "multi_output_unet3d",
}


def _detect_family(checkpoint_path: str) -> str:
    """Map the checkpoint's self-described model_name to its facade family.
    ``checkpoint.peek`` reads no weight bytes of either format; a legacy
    (pre-zip) ``.pt`` it cannot map takes a full ``checkpoint.load``."""
    from . import checkpoint

    try:
        hp = checkpoint.peek(checkpoint_path)["hyperparams"]
    except ValueError:
        hp = checkpoint.load(checkpoint_path)["hyperparams"]
    name = hp.get("model_name") or hp.get("network")
    family = _MODEL_FAMILY.get(name)
    if family is None:
        raise SystemExit(
            f"cannot infer family from checkpoint model '{name}' — pass --family")
    return family


def _add_predict(sub):
    p = sub.add_parser("predict", help="tiled inference on a tif/movie")
    p.add_argument("--family", default=None, choices=FAMILIES,
                   help="default: inferred from the checkpoint's model_name")
    p.add_argument("--input", required=True, help="tif file to predict")
    p.add_argument("--output", required=True,
                   help="result tif (single-head) or directory (multi-head)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--resize-dim", type=int, nargs="+", default=[512, 512])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--half-precision", action="store_true")
    p.add_argument("--device-pipeline", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="force the fused on-card path on or off "
                        "(default: auto — on for uint8/uint16 inputs)")
    p.add_argument("--quantized", action="store_true",
                   help="w8a8 int8 inference on the card for the families of "
                        "the int8 gate set; other families warn and run bf16 "
                        "unless BIU_INT8_EXPERIMENTAL=1 forces int8")
    _add_device(p)


def _resolve_heads(args):
    """Build the ``output_heads`` config for multi_output training: from
    --heads-json (inline JSON or a file path), else one head per target dir
    (the reference's head schema, multi_output_unet/multi_output_unet.py:16-21)."""
    import json
    import os

    if args.heads_json:
        if os.path.exists(args.heads_json):
            with open(args.heads_json) as fh:
                return json.load(fh)
        return json.loads(args.heads_json)
    heads = {}
    for d in args.target_dir:
        key = os.path.basename(os.path.normpath(d))
        if "orientation" in key:
            heads[key] = {"channels": 2, "activation": None,
                          "loss": "WeightedVectorFieldLoss", "weight": 1.0}
        else:
            heads[key] = {"channels": 1, "activation": "sigmoid",
                          "loss": "BCEDiceLoss", "weight": 1.0}
    return heads


def _train(parser, args, pkg) -> int:
    import os

    dim = tuple(args.dim)
    if args.family.endswith("3d") and len(dim) != 3:
        parser.error(f"family {args.family} needs --dim Z X Y (3 values), "
                     f"got {len(dim)}")
    common = dict(
        num_epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        n_filter=args.n_filter, save_dir=os.path.join(args.workdir, "model"),
        device_cache=args.device_cache, half_precision=args.half_precision,
        device_augment=args.device_augment, device=args.device,
    )
    if args.network:
        common["network"] = args.network

    if args.family.startswith("multi_output"):
        if not args.target_dir:
            parser.error("multi_output families require --target-dir "
                         "(repeatable, one per head)")
        heads = _resolve_heads(args)
        data_dir = os.path.join(args.workdir, "data")
        if args.family == "multi_output_unet":
            keys = [os.path.basename(os.path.normpath(d)) for d in args.target_dir]
            data = pkg.DataProcess(args.image_dir, args.target_dir, {k: k for k in keys},
                                   data_dir=data_dir, dim_out=dim, aug_factor=args.aug_factor)
            common["deep_supervision"] = args.deep_supervision
        else:
            data = pkg.DataProcess(args.image_dir, args.target_dir, data_dir=data_dir,
                                   dim_out=dim, aug_factor=args.aug_factor)
        if args.resume:
            common["load_weights"] = True
        trainer = pkg.Trainer(data, output_heads=heads, **common)
    else:
        if not args.label_dir:
            parser.error(f"--label-dir is required for family {args.family}")
        data = pkg.DataProcess(
            (args.image_dir.rstrip("/") + "/", args.label_dir.rstrip("/") + "/"),
            dim_out=dim, aug_factor=args.aug_factor,
            data_path=os.path.join(args.workdir, "data"),
        )
        common["loss_function"] = args.loss
        if args.family == "siam_unet":
            common["mode"] = args.mode
        # a resume reads <workdir>/model/model.ckpt; siam_unet's default is None
        if args.resume:
            common["load_weights"] = True
        elif args.family != "siam_unet":
            common["load_weights"] = False
        trainer = pkg.Trainer(data, **common)
    best = trainer.start()
    print(f"best validation loss: {best:.5f}")
    print(f"checkpoint: {os.path.join(args.workdir, 'model', 'model.ckpt')}")
    return 0


def _predict(parser, args, pkg) -> int:
    resize = tuple(args.resize_dim)
    if args.family == "unet3d" and len(resize) != 3:
        if resize == (512, 512):  # the untouched 2D default: a 3D default instead
            resize = (16, 256, 256)
        else:
            parser.error(f"family {args.family} needs --resize-dim Z X Y "
                         f"(3 values), got {len(resize)}")
    kwargs = dict(show_progress=True, batch_size=args.batch_size,
                  half_precision=args.half_precision, device=args.device)
    # None = the library's auto default; only an explicit --device-pipeline /
    # --no-device-pipeline overrides it
    if args.device_pipeline is not None:
        kwargs["device_pipeline"] = args.device_pipeline
    if args.quantized:
        kwargs["quantized"] = True
    if args.family.startswith("multi_output"):
        pkg.Predict(args.input, args.checkpoint, result_path=args.output, **kwargs)
    else:
        pkg.Predict(args.input, args.output, args.checkpoint, resize_dim=resize, **kwargs)
    print(f"wrote {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bio_image_unet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train(sub)
    _add_predict(sub)
    sub.add_parser("devices", help="list the visible CUDA devices")
    args = parser.parse_args(argv)

    if args.command == "devices":
        from .tools import device_test

        return 0 if device_test(verbose=True) else 1

    import importlib

    from .utils.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: fail before any work
    if args.command == "predict" and args.family is None:
        args.family = _detect_family(args.checkpoint)
    pkg = importlib.import_module(f"{__package__}.{args.family}")
    if args.command == "train":
        return _train(parser, args, pkg)
    return _predict(parser, args, pkg)


if __name__ == "__main__":
    sys.exit(main())
