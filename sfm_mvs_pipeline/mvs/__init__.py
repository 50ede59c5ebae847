"""Dense multi-view stereo: the openMVS replacement.

The reference delegates densification/meshing to the external openMVS C++
library (ref: src/photogrammetrie/mvs/MVS.cpp:112-181); here the dense math
is first-class: rectified or plane-sweep depth maps, PatchMatch, SGM
cost-volume aggregation (--sgm), multi-view consistency fusion, meshing.
"""
