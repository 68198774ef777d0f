"""CLI entry point: `python -m tpu_qe_torch <subcommand>`.

  verify   scene -> morton -> LSD radix sort on the device, sortedness and
           all-zeros checks, keys and payload order bit-exact against the
           C++ pipeline oracle; prints VERIFY PASS / VERIFY FAIL (exit 0/1)
  dump     golden-file dump of morton codes + triangle indices
  bench    headline benchmark (tpu_qe_torch/bench/headline.py)
  bench-kernels  one JSON row per kernel against the card's HBM
           speed of light (tpu_qe_torch/bench/kernels.py)
  bench-matrix   the operator configs (filter + GROUP BY, joins, ORDER
           BY, window, quantile, ...), radix backend beside torch.sort, one
           JSON row each (tpu_qe_torch/bench/matrix.py)
  bench-big      the out-of-core sort of 2^30 generated u64 keys + u32
           payload with its certificates, one JSON line; --distributed
           over a mesh of shards (tpu_qe_torch/bench/big.py)
  bench-bigagg, bench-bigjoin (--outer), bench-bigpipe, bench-bigtopk,
  bench-bigdistinct, bench-bigsetops, bench-bigquantile (--cont),
  bench-bigwindow, bench-bigorderby
           the out-of-core operators at the JAX CLI's sizes, verified on
           the device, one JSON line each; --distributed over a mesh of
           shards (tpu_qe_torch/bench/bigops.py)
  bench-bigsql   the out-of-core SQL tier over virtual tables: one of ten
           verbs (--verb) at the JAX CLI's sizes, checked against its closed
           form, one JSON line (tpu_qe_torch/bench/bigsql.py)
  info     device + configuration report

The on-card self-check of every kernel and sort backend against its
oracle is `python -m tpu_qe_torch.selfcheck`.

Every subcommand that touches a device takes --device (default cuda); a
CUDA device on a machine without CUDA raises instead of running elsewhere.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("tpu_qe_torch")


def _cmd_verify(args) -> int:
    import numpy as np
    import torch

    from tpu_qe_torch import morton, native
    from tpu_qe_torch.bits import is_sorted_u64, masked_key
    from tpu_qe_torch.config import (EngineConfig, SceneConfig, SortConfig,
                                     resolve_device)
    from tpu_qe_torch.pipeline import scene_tensors
    from tpu_qe_torch.sort import sort_u64
    from tpu_qe_torch.utils.profiling import span, trace_session

    dev = resolve_device(args.device)
    cfg = EngineConfig(
        sort=SortConfig(backend=args.backend,
                        bits_per_pass=args.bits_per_pass,
                        num_passes=args.num_passes),
        scene=SceneConfig(num_vertices=args.vertices,
                          num_triangles=args.triangles, seed=args.seed),
        trace_dir=args.trace_dir,
    )
    sc = cfg.scene
    log.info("verify run: %d vertices, %d triangles, seed %d, backend %s, "
             "device %s", sc.num_vertices, sc.num_triangles, sc.seed,
             cfg.sort.backend, dev)

    verts_t, tris_t, params = scene_tensors(sc, dev)

    with trace_session(cfg.trace_dir):
        with span("compute morton code"):
            code = morton.encode(verts_t, tris_t, params)
        idx = torch.arange(sc.num_triangles, dtype=torch.int32, device=dev)
        with span("radix sort"):
            skey, (sidx,) = sort_u64(code, idx, backend=cfg.sort.backend,
                                     key_bits=cfg.sort.key_bits,
                                     bits_per_pass=cfg.sort.bits_per_pass,
                                     block=cfg.sort.block)
        mlo, mhi = masked_key(skey.lo, skey.hi, cfg.sort.key_bits)
        ok_sorted = bool(is_sorted_u64(mlo, mhi))

    keys_np = skey.to_numpy()
    idx_np = sidx.cpu().numpy().view(np.uint32)

    # All-zeros detector (reference main.rs:852-864).
    all_zeros = int(np.count_nonzero(keys_np == 0)) == sc.num_triangles

    oracle_codes, oracle_idx = native.pipeline_oracle(
        sc.num_vertices, sc.num_triangles, sc.seed)
    keys_exact = bool(np.array_equal(keys_np, oracle_codes))
    idx_exact = bool(np.array_equal(idx_np, oracle_idx))

    if ok_sorted and not all_zeros:
        log.info("Sorted !!!!!!!!!")
    else:
        bad = int(np.count_nonzero(keys_np[1:] < keys_np[:-1]))
        log.error("Not sorted!!! %d", bad)
    log.info("oracle keys bit-exact: %s, payload order exact: %s",
             keys_exact, idx_exact)

    ok = ok_sorted and not all_zeros and keys_exact and idx_exact
    print("VERIFY PASS" if ok else "VERIFY FAIL")
    return 0 if ok else 1


def _cmd_dump(args) -> int:
    from tpu_qe_torch import native
    from tpu_qe_torch.utils.dump import dump_indices, dump_morton_codes

    verts, tris, smin, smax = native.scene_generate(
        args.vertices, args.triangles, args.seed)
    gen = native.MortonGen(smin, smax)
    codes = gen.encode(verts, tris, quirk=args.quirk_lut)
    p1 = dump_morton_codes(codes, args.codes_path)
    p2 = dump_indices(tris, args.indices_path)
    print(f"wrote {p1}\nwrote {p2}")
    return 0


def _cmd_bench(args) -> int:
    from tpu_qe_torch.bench import headline
    return headline.main(args.rest)


def _cmd_bench_kernels(args) -> int:
    from tpu_qe_torch.bench import kernels
    kernels.run(args.n)
    return 0


def _cmd_bench_matrix(args) -> int:
    from tpu_qe_torch.bench import matrix
    return matrix.main(args.configs.split(","), args.scale, args.device,
                       args.trace_dir, args.devices)


def _cmd_bench_big(args) -> int:
    from tpu_qe_torch.bench import big
    return big.main(args)


def _cmd_bench_bigops(args) -> int:
    from tpu_qe_torch.bench import bigops
    return bigops.main(args.cmd[len("bench-"):], args)


def _cmd_bench_bigsql(args) -> int:
    from tpu_qe_torch.bench import bigsql
    return bigsql.main(args)


def _add_bigops(sub) -> None:
    """The out-of-core operators' subcommands, with the JAX CLI's options
    and defaults (tpu_qe/__main__.py)."""

    def parser(name, help, run_size_help=None):
        p = sub.add_parser(name, help=help)
        p.add_argument("--run-size", type=int, default=1 << 26,
                       help=run_size_help)
        p.add_argument("--distributed", action="store_true",
                       help="the distributed operator (ops/dbig*.py) over "
                            "a mesh of shards")
        p.add_argument("--devices", type=int, default=None,
                       help="mesh size for --distributed (default: one "
                            "shard per card; D > 1 on one card is a "
                            "LocalMesh of D shards)")
        p.add_argument("--force-composed", action="store_true",
                       help="keep the composed path at --devices 1 (it "
                            "delegates to the single-device operator "
                            "otherwise)")
        p.add_argument("--verbose-big", action="store_true")
        p.add_argument("--trace-dir", type=str, default=None,
                       help="profile one more run: a Chrome trace here, "
                            "kernel time by category in the line")
        p.add_argument("--device", type=str, default="cuda")
        p.set_defaults(fn=_cmd_bench_bigops)
        return p

    pj = parser("bench-bigjoin", "out-of-core FK join (key-range buckets "
                "past join_fk_scan's 2^30 combined rows)",
                "per-device run size for --distributed")
    pj.add_argument("--n-left", type=int, default=1 << 29)
    pj.add_argument("--n-right", type=int, default=1 << 29)
    pj.add_argument("--buckets", type=int, default=None)
    pj.add_argument("--checkpoint-dir", type=str, default=None,
                    help="persist the bucket plan + completion here; a "
                         "killed run resumes with identical output")
    pj.add_argument("--outer", nargs="?", const="full",
                    choices=("left", "full"), default=None,
                    help="the out-of-core OUTER join instead "
                         "(ops/bigouter.py; default FULL)")

    pa = parser("bench-bigagg", "out-of-core GROUP BY (partial-aggregate "
                "runs + one combine)")
    pa.add_argument("--n", type=int, default=1 << 30)
    pa.add_argument("--groups", type=int, default=1 << 20)
    pa.add_argument("--minmax", action="store_true",
                    help="also aggregate per-group min + max")
    pa.add_argument("--value-cols", type=int, default=1,
                    help="SQL-shaped multi-column sums sharing one key "
                         "sort per run")
    pa.add_argument("--checkpoint-dir", type=str, default=None,
                    help="persist per-run partial tables here; a killed "
                         "run resumes from them")

    pp = parser("bench-bigpipe", "fused out-of-core join -> GROUP BY (the "
                "join output never stored)",
                "per-device run size for --distributed")
    pp.add_argument("--n-left", type=int, default=1 << 29)
    pp.add_argument("--n-right", type=int, default=1 << 29)
    pp.add_argument("--groups", type=int, default=1 << 16)
    pp.add_argument("--buckets", type=int, default=None)

    pt = parser("bench-bigtopk", "out-of-core top-k (per-run selection + "
                "one candidate combine)")
    pt.add_argument("--n", type=int, default=1 << 30)
    pt.add_argument("--k", type=int, default=1 << 10)
    pt.add_argument("--largest", action="store_true")

    pd = parser("bench-bigdistinct", "out-of-core COUNT(DISTINCT) GROUP BY "
                "(per-run pair dedup + one combine)")
    pd.add_argument("--n", type=int, default=1 << 30)
    pd.add_argument("--groups", type=int, default=1 << 16)
    pd.add_argument("--values", type=int, default=1 << 8,
                    help="distinct values per group")

    ps = parser("bench-bigsetops", "out-of-core UNION / INTERSECT / EXCEPT "
                "(per-run key dedup + one combine)")
    ps.add_argument("--op", choices=["union", "intersect", "except"],
                    default="intersect")
    ps.add_argument("--n-a", type=int, default=1 << 29)
    ps.add_argument("--n-b", type=int, default=1 << 29)
    ps.add_argument("--g-a", type=int, default=1 << 20)
    ps.add_argument("--g-b", type=int, default=1 << 20)
    ps.add_argument("--offset", type=int, default=1 << 19,
                    help="B key-range offset (dials the overlap)")

    pq = parser("bench-bigquantile", "out-of-core exact quantiles (sorted "
                "runs + bitwise selection; no merge phase)")
    pq.add_argument("--n", type=int, default=1 << 30)
    pq.add_argument("--qs", type=str, default="0.01,0.25,0.5,0.9,0.99",
                    help="comma-separated quantiles in [0,1]")
    pq.add_argument("--cont", action="store_true",
                    help="PERCENTILE_CONT (floor/ceil rank pairs + exact "
                         "fractional numerators)")

    pw = parser("bench-bigwindow", "out-of-core window functions (bucketed "
                "sort + sequential carry chain)")
    pw.add_argument("--n", type=int, default=1 << 29)
    pw.add_argument("--partitions", type=int, default=None)
    pw.add_argument("--buckets", type=int, default=None)
    pw.add_argument("--checkpoint-dir", type=str, default=None,
                    help="persist the plan + done-prefix carries here")

    po = parser("bench-bigorderby", "out-of-core multi-column ORDER BY "
                "(transformed-plane external sample sort)")
    po.add_argument("--n", type=int, default=1 << 30)
    po.add_argument("--a-card", type=int, default=None,
                    help="distinct values of the DESC u64 column")
    po.add_argument("--buckets", type=int, default=None)


def _cmd_info(args) -> int:
    import torch

    from tpu_qe_torch.config import EngineConfig, resolve_device

    dev = resolve_device(args.device)
    print(f"torch: {torch.__version__}, cuda: {torch.version.cuda}")
    print(f"device: {dev}")
    if dev.type == "cuda":
        from tpu_qe_torch.bench.sol import card, hbm_peak_bytes_per_s
        print(f"card: {card()}")
        print(f"hbm_peak: {hbm_peak_bytes_per_s() / 1e9:.0f} GB/s")
    print(f"config: {EngineConfig.from_env()}")
    return 0


def main(argv=None) -> int:
    from tpu_qe_torch.config import BACKENDS

    parser = argparse.ArgumentParser(prog="tpu_qe_torch")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("verify", help="headless verify run (device vs oracle)")
    pv.add_argument("--vertices", type=int, default=1000)
    pv.add_argument("--triangles", type=int, default=3000)
    pv.add_argument("--seed", type=int, default=7)
    pv.add_argument("--backend", type=str, default="radix",
                    choices=list(BACKENDS),
                    help="sort backend: the CUDA radix kernels, the "
                         "stable torch.sort baseline, or torch_tiebreak, "
                         "the same stable torch.sort under the JAX "
                         "xla_tiebreak name")
    pv.add_argument("--bits-per-pass", type=int, default=8)
    pv.add_argument("--num-passes", type=int, default=8,
                    help="e.g. --bits-per-pass 6 --num-passes 11 for the "
                         "reference's 6-bit test variant")
    pv.add_argument("--trace-dir", type=str, default=None)
    pv.add_argument("--device", type=str, default="cuda")
    pv.set_defaults(fn=_cmd_verify)

    pd = sub.add_parser("dump", help="golden-file dump (morton codes, indices)")
    pd.add_argument("--vertices", type=int, default=1000)
    pd.add_argument("--triangles", type=int, default=3000)
    pd.add_argument("--seed", type=int, default=7)
    pd.add_argument("--quirk-lut", action="store_true",
                    help="consume the LUTs like the shipped reference "
                         "kernel (i*3 byte shift) instead of the resolved "
                         "i*8 layout")
    pd.add_argument("--codes-path", type=str, default="morton_codes.txt")
    pd.add_argument("--indices-path", type=str, default="indices.txt")
    pd.set_defaults(fn=_cmd_dump)

    pb = sub.add_parser("bench", add_help=False,
                        help="headline benchmark (options: see "
                             "python -m tpu_qe_torch.bench.headline -h)")
    pb.set_defaults(fn=_cmd_bench)

    pk = sub.add_parser("bench-kernels",
                        help="per-kernel times against the HBM speed of "
                             "light (needs a CUDA card)")
    pk.add_argument("--n", type=int, default=1 << 24)
    pk.set_defaults(fn=_cmd_bench_kernels)

    pm = sub.add_parser("bench-matrix",
                        help="operator benchmark matrix, radix beside "
                             "torch.sort, with backend parity and invariant "
                             "checks (exit 1 if one fails)")
    pm.add_argument("--configs", type=str,
                    default="pipeline,filter_agg,join,join_agg",
                    help="comma-separated: pipeline, filter_agg, join, "
                         "join_agg, orderby, count_distinct, setop, window, "
                         "quantile, dsort")
    pm.add_argument("--scale", type=float, default=1.0,
                    help="row-count multiplier (e.g. 0.1 for smoke runs)")
    pm.add_argument("--device", type=str, default="cuda")
    pm.add_argument("--devices", type=int, default=None,
                    help="dsort's mesh: a LocalMesh of N shards on the "
                         "device (default: one shard per card)")
    pm.add_argument("--trace-dir", type=str, default=None,
                    help="profile one more radix run per config: Chrome "
                         "traces here, device time by kernel category in "
                         "the rows")
    pm.set_defaults(fn=_cmd_bench_matrix)

    pg = sub.add_parser("bench-big",
                        help="out-of-core big sort (north-star config)")
    pg.add_argument("--n", type=int, default=1 << 30)
    pg.add_argument("--run-size", type=int, default=1 << 26)
    pg.add_argument("--buckets", type=int, default=None)
    pg.add_argument("--verbose-big", action="store_true")
    pg.add_argument("--in-core", action="store_true",
                    help="one resident sort + verification of all rows")
    pg.add_argument("--checkpoint-dir", type=str, default=None,
                    help="persist the plan + per-bucket completion here; "
                         "a killed run resumes with identical output")
    pg.add_argument("--strategy", default="partition",
                    choices=["partition", "merge"],
                    help="partition-first (one key sort per row) or "
                         "sort-runs-then-merge (two)")
    pg.add_argument("--trace-dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of the whole "
                         "run here")
    pg.add_argument("--payload-cols", type=int, default=1,
                    help="u32 payload columns per row (>= 1): index + "
                         "carried value columns")
    pg.add_argument("--distributed", action="store_true",
                    help="distributed out-of-core sort over the mesh "
                         "(sort/dbigsort.py); --buckets is then buckets "
                         "per shard")
    pg.add_argument("--devices", type=int, default=None,
                    help="mesh size for --distributed: a LocalMesh of N "
                         "shards on the device (default: one per card)")
    pg.add_argument("--force-composed", action="store_true",
                    help="keep the composed path at one shard instead of "
                         "delegating to the single-device sort")
    pg.add_argument("--device", type=str, default="cuda")
    pg.set_defaults(fn=_cmd_bench_big)

    _add_bigops(sub)

    pz = sub.add_parser("bench-bigsql",
                        help="out-of-core SQL over device-generated virtual "
                             "tables (sql/bigexec.py), one verb per run")
    pz.add_argument("--n", type=int, default=1 << 30)
    pz.add_argument("--run-size", type=int, default=1 << 26)
    pz.add_argument("--groups", type=int, default=1 << 16)
    pz.add_argument("--median", action="store_true",
                    help="add MEDIAN(v) (the per-group bisection phase)")
    pz.add_argument("--where", action="store_true",
                    help="add a WHERE filter (fused validity mask)")
    pz.add_argument("--verb", default="groupby",
                    choices=["groupby", "orderby", "head", "distinct",
                             "countdistinct", "join", "window", "setops",
                             "range", "vvjoin"],
                    help="which big-SQL verb to measure (each checked "
                         "against a closed form at full size)")
    pz.add_argument("--trace-dir", type=str, default=None,
                    help="profile one more run: a Chrome trace here, "
                         "kernel time by category in the line")
    pz.add_argument("--device", type=str, default="cuda")
    pz.set_defaults(fn=_cmd_bench_bigsql)

    pi = sub.add_parser("info", help="device + config report")
    pi.add_argument("--device", type=str, default="cuda")
    pi.set_defaults(fn=_cmd_info)

    args, rest = parser.parse_known_args(argv)
    if args.cmd == "bench":
        args.rest = [a for a in rest if a != "--"]
    elif rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
