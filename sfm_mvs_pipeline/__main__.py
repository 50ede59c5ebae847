import os
import sys

# -Pthreads must reach the environment BEFORE numpy/jax initialize their
# OpenMP/BLAS pools: they read OMP_NUM_THREADS once at runtime init, so
# setting it later has no effect on them.
for _i, _a in enumerate(sys.argv):
    if _a.startswith("-Pthreads="):
        _v = _a.split("=", 1)[1]
        if _v.isdigit() and int(_v) > 0:
            # unconditional: the explicit CLI flag wins over ambient env
            # (ADVICE r4 — setdefault silently lost to CI-exported values)
            os.environ["OMP_NUM_THREADS"] = _v
            os.environ["OPENBLAS_NUM_THREADS"] = _v

from sfm_mvs_pipeline.cli.app import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
