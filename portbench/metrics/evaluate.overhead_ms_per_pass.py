"""Time of a pass outside its frames in the traced evaluation window:
(Σ `evaluate` spans + Σ `result.force` spans − Σ `eval.frame` spans) ÷
passes, in ms: the build of the Evaluator, the chunk and result
bookkeeping, and the wait for the device at the pass's end."""

from portbench import spans


def read(run):
    evaluate = spans.total_ms("evaluate")
    if evaluate is None:
        return None
    force = spans.total_ms("result.force") or 0.0
    frames = spans.total_ms("eval.frame") or 0.0
    return (evaluate + force - frames) / run.window["passes"]
