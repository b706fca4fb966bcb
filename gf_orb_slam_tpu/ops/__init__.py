"""Device compute kernels: ORB extraction front-end and Hamming matching.

Reference counterparts: src/ORBextractor.cc (pyramid FAST + rBRIEF) and
src/ORBmatcher.cc (grid-accelerated Hamming search). The redesign replaces
per-keypoint scalar loops with dense whole-image vector programs and replaces
grid bucketing with dense masked [Nq, Nt] distance matrices — the shapes an
accelerator's vector and matrix units actually like.
"""
