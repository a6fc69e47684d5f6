// The C entry points of K7 (MiB's unbiased KD of an upsampled
// student/teacher pair: forward sums and gradient), on the templates of
// upsample_ce.cuh (the family's design, bound and tolerance).

#include "upsample_ce.cuh"

// K7 forward: sem [n, h, w, c] and sem_old [n, h, w, c_old], both
// contiguous, both f32 or both bf16, 1 <= c_old < c; no labels; the plan of
// launch_plan with the stage counting c + c_old channels: t_out = per-image
// sums of T, b_out = per-image pixel counts.
extern "C" int upsample_ukd_sum(const void* sem, const void* sem_old, int sem_is_bf16, int n,
                                int h, int w, int c, int c_old, int H, int W, float alpha,
                                const void* tables, int band, int tile, int span, int rows,
                                void* partials, void* t_out, void* b_out, void* stream) {
  const Problem pr = make_problem(sem, sem_is_bf16, nullptr, 0, n, h, w, c, H, W, -1, tables,
                                  band, tile, span, rows);
  return sums(pr, UkdTerm{sem_old, c_old, alpha}, partials, t_out, b_out, stream);
}

// K7 backward: the student's dsem times the scalar g (the teacher takes
// none).
extern "C" int upsample_ukd_grad(const void* sem, const void* sem_old, int sem_is_bf16, int n,
                                 int h, int w, int c, int c_old, int H, int W, float alpha,
                                 const void* g, const void* tables, int band, int tile,
                                 int span, int rows, void* partials, void* dsem,
                                 void* stream) {
  const Problem pr = make_problem(sem, sem_is_bf16, nullptr, 0, n, h, w, c, H, W, -1, tables,
                                  band, tile, span, rows);
  return grad(pr, UkdTerm{sem_old, c_old, alpha}, g, partials, dsem, stream);
}
