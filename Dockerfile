# syntax=docker/dockerfile:1
# Container packaging for neo-ls-svm-jax, mirroring the reference's Dockerfile role
# (ref /root/reference/Dockerfile:1: python-slim base, non-root user, venv, test
# target) with a GPU runtime: the runtime image installs jax[cuda12] (JAX with its
# CUDA 12 plug-in and libraries), so the same image serves on NVIDIA GPU hosts run
# with `--gpus all`, and falls back to the CPU backend (with virtual devices for the
# sharding tests) everywhere else.
#
# Build + smoke-check (needs network; this build environment has none — CI runs it):
#   docker build --target test -t neo-ls-svm-jax:test .
#   docker build --target runtime -t neo-ls-svm-jax .
ARG PYTHON_VERSION=3.12
FROM python:${PYTHON_VERSION}-slim AS base

# Tracebacks on crash + unbuffered stdio (same rationale as the reference).
ENV PYTHONFAULTHANDLER=1 \
    PYTHONUNBUFFERED=1

# Non-root user (ref Dockerfile:15-21).
ARG UID=1000
ARG GID=$UID
RUN groupadd --gid $GID user && \
    useradd --create-home --gid $GID --uid $UID user --no-log-init && \
    chown user /opt/
USER user

ENV VIRTUAL_ENV=/opt/neo-ls-svm-jax-env
ENV PATH=$VIRTUAL_ENV/bin:$PATH
RUN python -m venv $VIRTUAL_ENV

WORKDIR /workspaces/neo-ls-svm-jax/


FROM base AS runtime

# Runtime dependencies. `jax[cuda12]` pulls the CUDA plug-in; on CPU-only hosts the
# same wheels run with JAX_PLATFORMS=cpu.
COPY --chown=user:user pyproject.toml README.md ./
COPY --chown=user:user neo_ls_svm_jax/ neo_ls_svm_jax/
RUN --mount=type=cache,uid=$UID,gid=$GID,target=/home/user/.cache/pip \
    pip install "jax[cuda12]>=0.9" && \
    pip install .

# Healthcheck: the package imports and a tiny fit round-trips on the available
# backend (CPU fallback when no GPU is attached).
HEALTHCHECK --interval=5m --timeout=120s CMD python -c "\
import numpy as np; from neo_ls_svm_jax import NeoLSSVM; \
g = np.random.RandomState(0); X = g.randn(256, 4).astype('float32'); \
m = NeoLSSVM().fit(X, X[:, 0]); m.predict(X[:8]); print('ok')"

CMD ["python"]


FROM runtime AS test

# The test image adds the dev dependencies and the suite; `docker build --target
# test` therefore gates the image on `pytest` + `bench --smoke` (the reference's
# dev container runs its suite the same way, ref .github/workflows/test.yml).
RUN --mount=type=cache,uid=$UID,gid=$GID,target=/home/user/.cache/pip \
    pip install pytest scikit-learn pandas
COPY --chown=user:user tests/ tests/
COPY --chown=user:user bench.py chip_smoke.py __graft_entry__.py ./
COPY --chown=user:user benchmark/ benchmark/
ENV JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    NEO_LS_SVM_ALLOW_MISSING_REFERENCE=1
RUN python -m pytest tests/ -q && python bench.py --smoke --skip-baseline
