"""App shell: global args, loglevel, subprogram dispatch.

Parity with the reference launcher (ref: src/cli/App.cpp:31-77):
  * -Ploglevel=0..4, --forceColoredOutput
  * -Pthreads=N caps host threadpools (the reference caps OMP threads,
    App.cpp:42-45; here it bounds our host-side worker pools)
  * -Prun=photogrammetrie|pcl-stats dispatch (App.cpp:47-55)
"""

from __future__ import annotations

import sys

from sfm_mvs_pipeline import APP_NAME, APP_VERSION
from sfm_mvs_pipeline.utils.args import AppArgs
from sfm_mvs_pipeline.utils import logger as logging

log = logging.AppLogger("App")


def print_usage() -> None:
    print(
        f"""{APP_NAME} {APP_VERSION}
Usage: python -m sfm_mvs_pipeline [-Prun=<subprogram>] [options]

Global options:
  -Prun=photogrammetrie|pcl-stats   subprogram to run (default photogrammetrie)
  -Ploglevel=0..4                   0=trace .. 4=error (default 2=info)
  -Pthreads=N                       cap host-side worker threads
  --forceColoredOutput              ANSI colors even when not a tty
  --help                            this message

Run `-Prun=<subprogram> --help` for subprogram options."""
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = AppArgs(argv)

    from sfm_mvs_pipeline.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    logging.set_level(args.get_int("loglevel", logging.INFO))
    logging.set_force_color(args.is_flag("forceColoredOutput"))

    # -Pthreads caps the host-side thread pools, the analogue of the
    # reference's global omp_set_num_threads (ref: src/cli/App.cpp:42-45).
    # Device compute is unaffected; this bounds the native kd-tree OMP
    # loops and host BLAS threading.
    threads = args.get_int("threads", 0)
    if threads > 0:
        import os

        os.environ["OMP_NUM_THREADS"] = str(threads)

    run = args.get("run", "photogrammetrie")
    if args.is_flag("help") and args.get("run") is None:
        print_usage()
        return 0

    if run == "photogrammetrie":
        from sfm_mvs_pipeline.cli.photogrammetrie import main as sub_main
    elif run == "pcl-stats":
        from sfm_mvs_pipeline.cli.pcl_stats import main as sub_main
    else:
        log.error(f"unknown subprogram: {run}")
        print_usage()
        return 2
    try:
        return sub_main(args)
    except Exception as e:  # top-level catch like the reference main.cpp:28-31
        log.error(f"{type(e).__name__}: {e}")
        if logging.get_level() <= logging.DEBUG:
            raise
        return 1
