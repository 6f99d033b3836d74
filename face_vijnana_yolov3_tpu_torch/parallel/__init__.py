"""Scale-out: process groups and the ("data", "model") mesh, data-parallel
serving, spatially split detection (the port of
face_vijnana_yolov3_tpu/parallel/)."""
