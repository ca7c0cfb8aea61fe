// Shared definitions of the port's CUDA kernels.
//
// Every kernel is exported through a plain C function that launches on the
// stream it is given (the caller passes torch.cuda.current_stream()),
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PSIM_EXPORT extern "C" __attribute__((visibility("default")))

// Slots of the packed parameter vector (core/params.py).
#define P_DT 0
#define P_GRAVITY 1
#define P_MOUSE_FORCE 2
#define P_MOUSE_RADIUS 3
#define P_DAMPING 4
#define P_MOUSE_X 6
#define P_MOUSE_Y 7
#define P_MOUSE_Z 8
#define P_DRAGGING 9
