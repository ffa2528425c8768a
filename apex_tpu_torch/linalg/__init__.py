"""Linear solvers of the port: the implicit Schur complement of bundle
adjustment. The banded solver is ROADMAP A.1, the dense solvers and the
explicit Schur variant A.3, the general-sparsity tier, banded QR and the
iterative normal-equation solver A.6."""
