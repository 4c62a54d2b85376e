/* Standalone C consumer of the port's C ABI (tuatara_capi.h): a synthetic
 * page -> tuatara_image_to_data -> one line a word, as the reference's
 * examples/resume.cpp prints its results. No Python host: the library
 * starts its own interpreter.
 *
 * Build it with `python -c "from tuatara_tpu_torch import capi;
 * print(capi.build_example())"`, then run it with PYTHONPATH reaching the
 * repo and torch's site-packages:
 *   ./capi_example                 synthetic page, random weights
 *   ./capi_example <weights_dir>   the reference examples' argv
 * TUATARA_TORCH_DEVICE=cpu runs the engine on the CPU; by default it runs
 * on the first CUDA card.
 */

#include <stdio.h>
#include <stdlib.h>

#include "tuatara_capi.h"

int main(int argc, char** argv) {
  const char* weights_dir = argc > 1 ? argv[1] : NULL;
  const int h = 96, w = 120, c = 3;
  unsigned char* img = (unsigned char*)malloc((size_t)h * w * c);
  if (img == NULL) return 1;
  /* a white page with two dark bars */
  for (int i = 0; i < h * w * c; ++i) img[i] = 255;
  for (int y = 20; y < 30; ++y)
    for (int x = 10; x < 60; ++x)
      for (int k = 0; k < c; ++k) img[(y * w + x) * c + k] = 10;
  for (int y = 50; y < 58; ++y)
    for (int x = 30; x < 90; ++x)
      for (int k = 0; k < c; ++k) img[(y * w + x) * c + k] = 10;

  TuataraItem items[64];
  int n = tuatara_image_to_data(img, h, w, c, weights_dir, NULL, items, 64);
  free(img);
  if (n < 0) {
    fprintf(stderr, "error: %s\n", tuatara_last_error());
    return 1;
  }
  printf("%d items\n", n);
  for (int i = 0; i < n; ++i) {
    printf("  text=%-12s bbox=[%.0f %.0f %.0f %.0f] conf=%.3g\n",
           items[i].text, items[i].bbox[0], items[i].bbox[1], items[i].bbox[2],
           items[i].bbox[3], items[i].confidence);
  }
  return 0;
}
