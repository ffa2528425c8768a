"""Linear solvers of the port: the implicit Schur complement of bundle
adjustment and the banded block cyclic reduction of pose graphs. The dense
solvers and the explicit Schur variant are ROADMAP A.3, the general-sparsity
tier, banded QR and the iterative normal-equation solver A.6."""
