"""Host-side foundations (numpy only, copies of ``aa_rmvsnet_tpu/core``):
PFM codec, MVSNet ``*_cam.txt`` / ``pair.txt`` parsing and projection
algebra, depth-hypothesis samplers, image transforms, the PLY writer."""
