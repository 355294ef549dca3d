"""Hand-written CUDA kernels, their wrappers and plain versions."""


def counted() -> dict:
    """The kernel wrappers by kernel name. Each adds one to its
    ``launches`` where it launches its kernel, and nowhere else."""
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    return {"render_level": fl.render_level, "train_level": fl.train_level,
            "train_level_twopass": fl.train_level_twopass,
            "mlp_fwd": fm.mlp_fwd, "mlp_bwd": fm.mlp_bwd}


def launch_counts() -> dict:
    """Each kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in counted().items()}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by kernel name) to the wrappers' counters: the
    launches of a CUDA-graph replay, which no wrapper sees."""
    for name, fn in counted().items():
        fn.launches += counts[name]
