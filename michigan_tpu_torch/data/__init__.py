"""Host prep for single-image inference and the trainer's loader: numpy / PIL
/ cv2 copies of the jax-free parts of michigan_tpu.data (importing that
package pulls in jax), plus a numpy-only synthetic batch for runs without the
image libraries."""
