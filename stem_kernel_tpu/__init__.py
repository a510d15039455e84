"""stem_kernel_tpu — an RNA kernel-machine engine in JAX for NVIDIA GPUs.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
keio-bioinformatics/stem_kernel (reference mounted at /root/reference):

- ``io``       FASTA/CLUSTAL/MAF parsers, IUPAC encoding, profile tensors
               (reference: common/fa.*, common/aln.*, common/maf.*, common/rna.*,
               common/profile.*).
- ``fold``     McCaskill partition function / base-pair probability matrices
               (reference: common/bpmatrix.*, common/pf_wrapper.* which wrap the
               external Vienna RNA library; here built in-framework).
- ``models``   The kernel functions: profile string kernel, BPLA local-alignment
               kernel (+ analytic gradients), stem DAG kernel, full O(n^4) stem
               kernel, pair HMM, palindrome kernel, combinators
               (reference: stem_kernel_lite/, bpla_kernel/, stem_kernel/,
               string_kernel/, simpal/, common/conv_kernel.h).
- ``ops``      Low-level batched DP primitives (linear/semiring recurrences,
               wavefront scans) and the Pallas Triton kernel of the BPLA
               local-alignment DP.
- ``gram``     The N x N Gram-matrix engine: pair batching, length bucketing,
               mesh-sharded tiles, normalization, LIBSVM-format I/O
               (reference: common/kernel_matrix.*, common/framework.*).
- ``svm``      SVM training/prediction on precomputed kernels: SMO solver,
               Platt probabilities, CV, LIBSVM-compatible model files
               (reference: libsvm/).
- ``opt``      Hyperparameter optimization: L-BFGS-B, smoothed-AUC objective with
               KKT hypergradients, rbf/poly/sigmoid kernel optimizers
               (reference: optimizer/).
- ``parallel`` Mesh construction, sharding helpers, multi-host bootstrap
               (reference: the MPI backend in common/kernel_matrix.cpp:184-483).
- ``utils``    ROC/AUC evaluation, dinucleotide shuffles, matrix transforms
               (reference: utils/).
- ``cli``      Command-line drivers mirroring the reference's 8 binaries.
"""

__version__ = "0.1.0"


def _enable_compile_cache() -> None:
    """Persist XLA executables across processes, for every import path.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is unset the
    cache goes to ``.jax_cache/`` at the root of the checkout, a fixed path
    listed in ``.gitignore`` (the path is part of the cache's key, so a
    directory that moves never hits).
    """
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(root, ".jax_cache"))


_enable_compile_cache()
