"""The port's counterparts of the repository's training tools (tools/):
the synthetic-shapes scenes drawn without cv2 (``raster``), the in-process
demo, the flagship yolov3-416 recipe and the backbone-transfer A/B."""
