"""Host-side helpers: logging, the image codec (``image_io``), pose math
(``motion``), profiling, visualization and the live viewer."""
