"""The production engine: compiles Waveform IR into jit/vmap-able
block-render programs."""

from .graph import (CompiledVoice, EngineConfig, compile_voice, render,
                    structure_key)

__all__ = ["CompiledVoice", "EngineConfig", "compile_voice", "render",
           "structure_key"]
