/* C ABI of the PyTorch port's OCR engine.
 *
 * The same ABI as the JAX package's native/tuatara_capi.h: the same
 * record, the same two functions with the same signatures. A C program
 * written against that header links against this library unchanged.
 * The library embeds a CPython interpreter on its first call (or joins
 * the one already running when it is loaded inside a Python process) and
 * routes through `tuatara_tpu_torch.image_to_data`, so C callers get the
 * port's pipeline, its engine cache included.
 *
 * The engine runs on the first CUDA card. The environment variable
 * TUATARA_TORCH_DEVICE names another torch device (e.g. "cpu"); without a
 * card and without the variable a call returns -1 and tuatara_last_error()
 * says "no CUDA device".
 */

#ifndef TUATARA_CAPI_H_
#define TUATARA_CAPI_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  char text[256];   /* UTF-8, NUL-terminated (truncated if longer) */
  float bbox[4];    /* x0, y0, x1, y1 */
  float confidence; /* sequence probability in [0, 1] */
} TuataraItem;

/* OCR an interleaved uint8 image (channels = 1 grayscale or 3 RGB; row-major
 * [height][width][channels]). Writes up to max_items records into out.
 * Returns the number of items written, or -1 on error (see
 * tuatara_last_error). weights_dir may be NULL or "" for randomly
 * initialized weights (seed 0); outputs_dir is accepted for signature
 * parity with the reference and ignored. */
int tuatara_image_to_data(const unsigned char* image, int height, int width,
                          int channels, const char* weights_dir,
                          const char* outputs_dir, TuataraItem* out,
                          int max_items);

/* Message for the last error on this thread ("" if none). */
const char* tuatara_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* TUATARA_CAPI_H_ */
