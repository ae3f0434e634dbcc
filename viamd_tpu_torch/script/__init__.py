"""VIAMD script language: parser (copy) + torch compiler + filter queries."""

from viamd_tpu_torch.script.compiler import CompiledScript, compile_script
from viamd_tpu_torch.script.filterlang import evaluate_filter
from viamd_tpu_torch.script.parser import ScriptError, parse

__all__ = ["CompiledScript", "ScriptError", "compile_script", "evaluate_filter", "parse"]
