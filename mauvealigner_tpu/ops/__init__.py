"""Device compute kernels (JAX/XLA).

K1 merops    — spaced-mer pack + canonicalize + sort (SML construction)
K2 matchops  — multi-way mer merge + multi-MUM enumeration
K3 dp        — banded affine-gap DP (gapped-alignment engine)
K4 hmm       — homology pair-HMM forward/backward scans
   score     — substitution/SP/identity column scans
"""
