// The C entry points of K1 (plain CE: forward sums and gradient) and K8
// (K1's gradient with a per-image cotangent), on the templates of
// upsample_ce.cuh (the family's design, bound and tolerance).

#include "upsample_ce.cuh"

// K1 forward: a_out = per-image NLL sums, b_out = valid counts.
extern "C" int upsample_ce_sums(const void* sem, int sem_is_bf16, const void* labels,
                                int labels_are_i64, int n, int h, int w, int c, int H,
                                int W, int ignore_index, const void* tables, int band,
                                int tile, int span, int rows, void* partials,
                                void* loss_out, void* count_out, void* stream) {
  return sums(PROBLEM, CeTerm{}, partials, loss_out, count_out, stream);
}

// K1 backward.
extern "C" int upsample_ce_grad(const void* sem, int sem_is_bf16, const void* labels,
                                int labels_are_i64, int n, int h, int w, int c, int H,
                                int W, int ignore_index, const void* g,
                                const void* tables, int band, int tile, int span,
                                int rows, void* partials, void* dsem, void* stream) {
  return grad(PROBLEM, CeTerm{}, g, partials, dsem, stream);
}

// K8: K1 backward with g f32 [n], one cotangent per image.
extern "C" int upsample_ce_grad_per_image(const void* sem, int sem_is_bf16,
                                          const void* labels, int labels_are_i64, int n,
                                          int h, int w, int c, int H, int W,
                                          int ignore_index, const void* g,
                                          const void* tables, int band, int tile,
                                          int span, int rows, void* partials,
                                          void* dsem, void* stream) {
  return grad(PROBLEM, CeTerm{}, g, partials, dsem, stream, 1);
}
