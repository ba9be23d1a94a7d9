import sys

# --platform is applied before anything can initialize a JAX backend, after
# which jax.config.update("jax_platforms", ...) would have no effect.
if "--platform" in sys.argv:
    try:
        platform = sys.argv[sys.argv.index("--platform") + 1]
    except IndexError:
        platform = None
    if platform in ("cpu", "gpu"):
        import jax
        jax.config.update("jax_platforms", platform)

from .cli import main  # noqa: E402

sys.exit(main())
