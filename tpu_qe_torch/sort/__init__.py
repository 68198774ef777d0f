from tpu_qe_torch.sort.driver import sort_u64, sort_u64_numpy  # noqa: F401
