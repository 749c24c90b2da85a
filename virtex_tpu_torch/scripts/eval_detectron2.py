r"""
Detectron2 transfer of a pretrained visual backbone (COCO and LVIS
instance segmentation, VOC 07+12 detection), in the PyTorch port.

Counterpart of ``scripts/eval_detectron2.py``: the backbone of
``MODEL.VISUAL.NAME`` is built on the card (unless ``--device cpu``),
initialised by ``--weight-init`` (``virtex``: a pretraining checkpoint;
``torchvision``: a torchvision ``.pth``; ``random``; ``imagenet``, a
download, is refused), renamed to Detectron2's names
(``detectron2_backbone_state_dict``) and written to ``--output`` (default
``<serialization-dir>/virtex_backbone_d2.pkl``). Where detectron2 is
installed, its trainer then fine-tunes from it: the task config
``--d2-config`` patched by ``--d2-config-override``, the ResNet depth from
the visual name, the ``Res5ROIHeadsExtraNorm`` ROI head of the VOC
configs, the VOC, COCO or LVIS evaluator by dataset, ``--resume`` from
Detectron2's own checkpoint and ``--eval-only``; the evaluation's results
go to the log. Without detectron2 the export is the result and the script
exits 0.

    python -m virtex_tpu_torch.scripts.eval_detectron2 \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --d2-config configs/detectron2/coco_segm_default_init_2x.yaml \
        --weight-init virtex --checkpoint-path /tmp/virtex_run/checkpoint_best.pth \
        --serialization-dir /tmp/coco_segm
"""
from __future__ import annotations

import logging
import os
import pickle
import re
from typing import Any, Dict

import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.engine.checkpointing import apply_backbone_weight_init
from virtex_tpu_torch.factories import VisualBackboneFactory
from virtex_tpu_torch.modules.visual_backbones import (
    detectron2_backbone_state_dict,
)
from virtex_tpu_torch.utils.common import common_parser, common_setup

logger = logging.getLogger("virtex_tpu_torch")


def infer_resnet_depth(visual_name: str) -> int:
    """Detectron2's ``MODEL.RESNETS.DEPTH`` from the visual name:
    ``[torchvision::]resnet<depth>``, else the Detectron2 grammar's
    ``_R_<depth>``, else 0."""
    m = re.search(r"resnet(\d+)", visual_name)
    if m:
        return int(m.group(1))
    m = re.search(r"_R_(\d+)", visual_name)
    return int(m.group(1)) if m else 0


def gather_backbone_weights(_C: Config, weight_init: str,
                            checkpoint_path=None,
                            device: torch.device = torch.device("cuda")
                            ) -> Dict[str, Any]:
    """The backbone of ``MODEL.VISUAL.NAME`` on ``device``, initialised by
    ``weight_init``, as ``{"model", "__author__",
    "matching_heuristics"}`` in Detectron2's names."""
    visual = VisualBackboneFactory.create(_C.MODEL.VISUAL.NAME).to(device)
    apply_backbone_weight_init(visual, weight_init, checkpoint_path)
    return detectron2_backbone_state_dict(visual)


def register_extra_norm_roi_heads() -> None:
    """Register ``Res5ROIHeadsExtraNorm``, the res5 stage followed by a
    norm layer, which the C4 VOC config names. Idempotent."""
    import detectron2 as d2
    from detectron2.modeling.roi_heads import ROI_HEADS_REGISTRY, Res5ROIHeads

    if "Res5ROIHeadsExtraNorm" in getattr(ROI_HEADS_REGISTRY, "_obj_map", {}):
        return

    @ROI_HEADS_REGISTRY.register()
    class Res5ROIHeadsExtraNorm(Res5ROIHeads):
        def _build_res5_block(self, cfg):
            seq, out_channels = super()._build_res5_block(cfg)
            seq.add_module("norm", d2.layers.get_norm(
                cfg.MODEL.RESNETS.NORM, out_channels))
            return seq, out_channels


def build_detectron2_config(_C: Config, _A):
    """Detectron2's defaults, then ``--d2-config``, then
    ``--d2-config-override``; the workers, checkpoint period and output
    directory from the run's flags, the depth from the visual name."""
    import detectron2 as d2

    _D2C = d2.config.get_cfg()
    _D2C.merge_from_file(_A.d2_config)
    _D2C.merge_from_list(_A.d2_config_override)
    _D2C.DATALOADER.NUM_WORKERS = _A.cpu_workers
    _D2C.SOLVER.CHECKPOINT_PERIOD = _A.checkpoint_every
    _D2C.OUTPUT_DIR = _A.serialization_dir
    _D2C.MODEL.RESNETS.DEPTH = infer_resnet_depth(_C.MODEL.VISUAL.NAME)
    return _D2C


def run_detectron2(_C: Config, _A, weights: Dict[str, Any]):
    """Fine-tune (or, with ``--eval-only``, evaluate) a Detectron2 model
    from the exported weights, or resume Detectron2's own checkpoint with
    ``--resume``. Returns the evaluation's flat results (None when it
    trained)."""
    import detectron2 as d2
    from detectron2.checkpoint import DetectionCheckpointer
    from detectron2.engine import DefaultTrainer, default_setup
    from detectron2.evaluation import (
        COCOEvaluator,
        LVISEvaluator,
        PascalVOCDetectionEvaluator,
    )

    register_extra_norm_roi_heads()
    _D2C = build_detectron2_config(_C, _A)
    default_setup(_D2C, _A)

    class DownstreamTrainer(DefaultTrainer):
        def __init__(self, cfg, weights):
            super().__init__(cfg)
            if isinstance(weights, str):
                # save_dir: resume_or_load finds OUTPUT_DIR's
                # last_checkpoint there (else it looks in the CWD)
                self.start_iter = DetectionCheckpointer(
                    self._trainer.model, save_dir=cfg.OUTPUT_DIR,
                    optimizer=self._trainer.optimizer,
                    scheduler=self.scheduler,
                ).resume_or_load(weights, resume=True).get(
                    "iteration", -1) + 1
            else:
                DetectionCheckpointer(self._trainer.model)._load_model(
                    weights)

        @classmethod
        def build_evaluator(cls, cfg, dataset_name, output_folder=None):
            output_folder = output_folder or os.path.join(
                cfg.OUTPUT_DIR, "inference")
            kind = d2.data.MetadataCatalog.get(dataset_name).evaluator_type
            if kind == "pascal_voc":
                return PascalVOCDetectionEvaluator(dataset_name)
            # cfg positionally: the evaluators of detectron2 >= 0.4 take
            # it through their `tasks` argument's compatibility path
            if kind == "coco":
                return COCOEvaluator(dataset_name, cfg, True, output_folder)
            if kind == "lvis":
                return LVISEvaluator(dataset_name, cfg, True, output_folder)
            raise NotImplementedError(kind)

    if _A.resume:
        weights = _A.checkpoint_path or ""  # "": OUTPUT_DIR's last one
    trainer = DownstreamTrainer(_D2C, weights)
    if not _A.eval_only:
        trainer.train()
        return None
    flat = d2.evaluation.testing.flatten_results_dict(trainer.test())
    for key, value in flat.items():
        logger.info(f"{key}: {value}")
    return flat


def build_parser():
    parser = common_parser(description="Detectron2 transfer and export of "
                           "the visual backbone (PyTorch port).")
    parser.add_argument("--d2-config", default=None,
                        help="Detectron2 task config (configs/detectron2/).")
    parser.add_argument("--d2-config-override", nargs="*", default=[],
                        help="Key-value pairs patching the Detectron2 "
                             "config.")
    parser.add_argument(
        "--weight-init", default="virtex",
        choices=["random", "imagenet", "torchvision", "virtex"],
        help="random: fresh; torchvision: a torchvision .pth from "
             "--checkpoint-path; virtex: a pretraining checkpoint; "
             "imagenet (a download) is refused.")
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("--output", default=None,
                        help="Path of the exported backbone pickle.")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    return parser


def main(_A) -> Dict[str, Any]:
    """Export, then fine-tune or evaluate where detectron2 is installed.
    Returns the exported weights, the pickle's path and the evaluation's
    results (None without detectron2 or when it trained)."""
    _C = Config(_A.config, _A.config_override)
    device = common_setup(_C, _A, job_type="eval_detectron2")
    weights = gather_backbone_weights(_C, _A.weight_init,
                                      _A.checkpoint_path, device)
    output = _A.output or os.path.join(_A.serialization_dir,
                                       "virtex_backbone_d2.pkl")
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "wb") as f:
        pickle.dump(weights, f)
    logger.info(f"Exported {len(weights['model'])} backbone tensors to "
                f"{output}")
    result = {"weights": weights, "output": output, "results": None}
    try:
        import detectron2  # noqa: F401
    except ImportError:
        logger.info("detectron2 is not installed: the export is complete; "
                    f"point MODEL.WEIGHTS of a Detectron2 run at {output}")
        return result
    result["results"] = run_detectron2(_C, _A, weights)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
