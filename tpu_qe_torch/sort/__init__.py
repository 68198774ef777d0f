from tpu_qe_torch.sort.driver import sort_u64, sort_u64_numpy  # noqa: F401


def __getattr__(name):
    # lazy: the out-of-core sorts pull in the exchange layer, which the
    # plain sort path does not need
    if name in ("sort_big", "sort_big_incore"):
        from tpu_qe_torch.sort import bigsort
        return getattr(bigsort, name)
    if name == "sort_big_distributed":
        from tpu_qe_torch.sort.dbigsort import sort_big_distributed
        return sort_big_distributed
    raise AttributeError(name)
