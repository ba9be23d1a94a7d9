"""tuun-jax: a JAX rebuild of the Tuun sound & music synthesis system.

Layers (mirroring the reference architecture, re-designed for JAX/XLA):
  * ir / optimizer          — Waveform IR and algebraic canonicalizer
  * expr / parser / eval /
    builtins / evaluator    — the Tuun expression language front-end
  * oracle                  — sample-exact NumPy reference engine (testing +
                              host-side length/mark computation)
  * engine                  — the production path: compiles IR into jit-able,
                              vmap-able block-render programs for the GPU
  * tracker / player / cli  — the batched polyphonic render runtime
"""

__version__ = "0.1.0"
