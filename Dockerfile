# Deployment image for the k-mer annotation engine (CPU base image: run
# it with a CUDA-enabled JAX for the GPU path).
# Counterpart of the reference's KBase sdkbase image + entrypoint
# (the reference repo's Dockerfile, scripts/entrypoint.sh).
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /kb/module
COPY pyproject.toml README.md Makefile ./
COPY kmergutsjava_tpu ./kmergutsjava_tpu
COPY native ./native
COPY scripts ./scripts
# prebuild every native component (feeder, grouping, scatter+decode,
# fasta, baseline); each also rebuilds on demand via the ctypes loaders
RUN pip install --no-cache-dir . && make all

# Reference data (kmer.table.mem_map + function.index) mounts at /data,
# matching the reference test harness convention.
VOLUME ["/data"]
EXPOSE 5000

ENTRYPOINT ["/kb/module/scripts/entrypoint.sh"]
