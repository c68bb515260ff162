// The min of the group-min epilogues: NaN when either input is NaN.
//
// fminf returns the other operand when one is NaN, so a NaN distance (a
// corpus row holding +inf gives inf - inf under the l2 norm identity) would
// vanish from its group's min. The plain version's torch.min and tpu_knn's
// jnp.min carry it, and the exact scan then ranks that row first. PTX has the
// NaN-carrying min as one instruction (min.NaN.f32, PTX ISA 7.0, sm_80 and
// up), the same single min as fminf.

#pragma once

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The NaN-carrying max (max.NaN.f32), for what the plain versions take with
// torch.amax or torch.clamp_min: fmaxf would drop the NaN as fminf does.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
