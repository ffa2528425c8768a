"""Linear solvers of the port: the implicit Schur complement of bundle
adjustment, the banded block cyclic reduction of pose graphs, and the dense
Cholesky and QR solvers. The explicit Schur variant is ROADMAP A.3, the
general-sparsity tier, banded QR and the iterative normal-equation solver
A.6."""
