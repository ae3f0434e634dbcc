"""Evaluation engine: drive a compiled script over a trajectory."""

from viamd_tpu_torch.eval.engine import (
    ChunkStream,
    EvalResult,
    Evaluator,
    evaluate,
    load_checkpoint,
    merge_results,
    save_checkpoint,
)

__all__ = [
    "ChunkStream", "EvalResult", "Evaluator", "evaluate", "load_checkpoint",
    "merge_results", "save_checkpoint",
]
