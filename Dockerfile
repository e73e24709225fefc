# Runtime images for the collision_tpu library, mirroring the reference's
# two-variant layout (/root/reference/Dockerfile: one venv build stage, then
# `nvidia` and `cpu` runtimes). Here the variants are `gpu` (JAX with its
# CUDA 12 plugin; runs the on-card smoke test) and `cpu` (JAX CPU backend —
# the PoCL analog used to run the test suite anywhere).

FROM python:3.12-slim AS build
WORKDIR /src
COPY pyproject.toml README.md ./
COPY collision_tpu ./collision_tpu
RUN python -m venv /venv && /venv/bin/pip install --upgrade pip && \
    /venv/bin/pip install .

FROM python:3.12-slim AS cpu
COPY --from=build /venv /venv
ENV PATH=/venv/bin:$PATH JAX_PLATFORMS=cpu
WORKDIR /opt/collision
COPY collision_tpu ./collision_tpu
COPY tests ./tests
COPY chip_smoke.py __graft_entry__.py ./
RUN pip install pytest pytest-xdist
CMD ["python", "-m", "pytest", "tests", "-q"]

FROM python:3.12-slim AS gpu
COPY --from=build /venv /venv
ENV PATH=/venv/bin:$PATH
RUN /venv/bin/pip install "jax[cuda12]>=0.9"
WORKDIR /opt/collision
COPY collision_tpu ./collision_tpu
COPY chip_smoke.py bench.py ./
CMD ["python", "chip_smoke.py"]
