"""Host-side helpers: logging and PLY point clouds."""
