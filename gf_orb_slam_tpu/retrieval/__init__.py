"""Device-resident place recognition: binary BoW vocabulary tree + keyframe
database (reference: Thirdparty/DBoW2 + src/KeyFrameDatabase.cc).
"""
