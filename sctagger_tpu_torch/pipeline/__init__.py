from .runner import run_pipeline  # noqa: F401
