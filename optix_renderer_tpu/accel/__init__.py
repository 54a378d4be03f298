"""Acceleration structures: host LBVH build + device wavefront traversal.

Replaces the reference's hardware path (OWL BLAS/TLAS + RT-core
``owl::traceRay``, include/viewer.hpp:506-517, cuda_src/deviceCode.cu:76)
— the reference has zero first-party traversal code, so this subpackage is
designed from scratch rather than ported (SURVEY.md §2.2 "BVH traversal").
"""
