"""Plain torch versions of alacjax's device ops (the reference each CUDA
kernel is held to, and the CPU path of every kernel wrapper)."""
