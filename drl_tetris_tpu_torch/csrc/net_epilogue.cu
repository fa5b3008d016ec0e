// The residual layer's epilogue on channels-last tensors: the bias add, the
// peephole join with the layer input and the activation after a
// convolution of models/nets.py ResidualBlock, in one pass.
//
//   out = act(join(c + bias, y)),  c (P, n), y (P, c_in), out (P, c_out),
//
// P = B * H * W pixels, each a row of channels (NHWC).  join is
// peephole_join's 'add' (the smaller side added onto the leading channels
// of the larger, the larger side's other channels passed through; c_out =
// max(n, c_in)) or 'truncate_add' (the sum alone; c_out = min(n, c_in)).
// c_in = 0 is a block without peepholes: out = act(c + bias).  Rows may be
// longer than their channels: y's rows hold y_stride >= c_in values, and
// out's out_stride >= c_out, the values past c_out written as zeros.  The
// net pads its rows to a multiple of 8 channels so: cuDNN's tensor-core
// convolutions read such rows as they are, where a 76- or 154-channel row
// costs them a padding pass of their own before every conv.
//
// Replaces no TPU kernel: the JAX package left the net to XLA, which fuses
// this chain into the convolution's consumer.  In PyTorch's eager form it
// was four passes or more over the activation (the bias add, the strided
// peephole add, a cat that copies everything again, elu) in NCHW, around
// cuDNN kernels that transpose every input to NHWC and every output back.
// With the activations kept channels-last, this kernel writes the tensor
// the next convolution reads.
//
// Bound: bytes.  Each element of c and y is read once and each element of
// out written once; an element costs a few float operations (one expm1f
// for elu), far below the card's 295 bf16 operations a byte.  So the
// design is about the memory system alone: a CUDA block covers whole
// pixels, threadIdx.x walks a pixel's row in vectors of V elements and
// threadIdx.y the block's pixels, so a warp's accesses are contiguous
// rows.  V is 16 bytes' worth where the row lengths allow (every padded
// row: 64, 80, 128, 160 channels), else 8, 4 or 2 bytes; the wrapper picks
// it.  A layer input whose row V does not divide is read element by
// element.
//
// Rounding is PyTorch's eager chain, element by element: for bf16, t =
// bf16(c + bf16(bias)), s = bf16(t + y) on the shared channels, out =
// bf16(act(s)), every sum and the activation in float, elu as x > 0 ? x :
// expm1f(x) and tanh as tanhf.  Given the same c, the output is the eager
// chain's bit for bit.  Built without --fmad=false, as PyTorch's own
// kernels are, so that the math library's expm1f and tanhf compile as
// theirs do.  float32 tensors (a block whose dtype is float32) run the same
// chain with no rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kElu = 1, kTanh = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x stored as a T and read back: where the eager chain writes a tensor.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

template <int ACT> __device__ __forceinline__ float activate(float x) {
  if (ACT == kElu) return x > 0.0f ? x : expm1f(x);
  if (ACT == kTanh) return tanhf(x);
  return x;
}

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// The launch's pointers and shapes: c (pixels, n), y (pixels, y_stride)
// of which the first cin channels are the layer input's, out (pixels,
// out_stride) of which the first cout are the join's.
struct Args {
  const void* c;
  const float* bias;
  const void* y;
  void* out;
  int64_t pixels;
  int n, cin, y_stride, cout, out_stride;
};

// One vector of V output channels [k0, k0 + V) of pixel p per thread and
// step.  V divides n and out_stride, so a vector lies wholly inside or
// outside the conv's channels; Y_VEC: V divides y_stride too (and y is
// aligned), so y's vectors can be loaded whole.
template <typename T, int V, int ACT, bool Y_VEC>
__global__ void __launch_bounds__(256) epilogue_kernel(const Args a) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= a.pixels) return;
  const T* yp = static_cast<const T*>(a.y) + p * a.y_stride;
  const int n = a.n, cin = a.cin, cout = a.cout;
  for (int k0 = threadIdx.x * V; k0 < a.out_stride; k0 += blockDim.x * V) {
    float s[V];
    if (k0 < n) {
      const Vec<T, V> cv = load<T, V>(static_cast<const T*>(a.c) + p * n + k0);
#pragma unroll
      for (int j = 0; j < V; ++j)
        s[j] = round_to<T>(widen(cv.v[j]) +
                           round_to<T>(__ldg(a.bias + k0 + j)));
      if (Y_VEC) {
        if (k0 < cin) {
          const Vec<T, V> yv = load<T, V>(yp + k0);
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (k0 + j < cin) s[j] = round_to<T>(s[j] + widen(yv.v[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (k0 + j < cin) s[j] = round_to<T>(s[j] + widen(yp[k0 + j]));
      }
    } else if (Y_VEC && k0 < cin) {   // past the conv's channels: y's pass
      const Vec<T, V> yv = load<T, V>(yp + k0);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = k0 + j < cin ? widen(yv.v[j]) : 0.0f;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        s[j] = k0 + j < cin ? widen(yp[k0 + j]) : 0.0f;
    }
    Vec<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.v[j] = narrow<T>(k0 + j < cout ? activate<ACT>(s[j]) : 0.0f);
    *reinterpret_cast<Vec<T, V>*>(static_cast<T*>(a.out) +
                                  p * a.out_stride + k0) = o;
  }
}

// A CUDA block of 256 threads: a pixel's row of vectors along x, pixels
// along y.
template <typename T, int V>
int launch(int act, bool y_vec, const Args& a, cudaStream_t stream) {
  const int nvec = a.out_stride / V;
  const int bx = nvec < 256 ? nvec : 256;
  const int by = 256 / bx;
  const dim3 block(bx, by), grid((unsigned)((a.pixels + by - 1) / by));
  if (act == kNone && y_vec)
    epilogue_kernel<T, V, kNone, true><<<grid, block, 0, stream>>>(a);
  else if (act == kNone)
    epilogue_kernel<T, V, kNone, false><<<grid, block, 0, stream>>>(a);
  else if (act == kElu && y_vec)
    epilogue_kernel<T, V, kElu, true><<<grid, block, 0, stream>>>(a);
  else if (act == kElu)
    epilogue_kernel<T, V, kElu, false><<<grid, block, 0, stream>>>(a);
  else if (act == kTanh && y_vec)
    epilogue_kernel<T, V, kTanh, true><<<grid, block, 0, stream>>>(a);
  else if (act == kTanh)
    epilogue_kernel<T, V, kTanh, false><<<grid, block, 0, stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 bfloat16, 1 float32; vec the elements per access (bf16 1, 2, 4
// or 8; float32 1, 2 or 4); act 0 none, 1 elu, 2 tanh; y_vec whether y is
// read in vectors; y may be null when cin is 0; device the tensors'
// device, which must be the current one.  Returns the launch's
// cudaError_t (cudaErrorInvalidDevice for another current device).
extern "C" int net_epilogue(int dtype, int vec, int act, int y_vec,
                            const void* c, const float* bias, const void* y,
                            void* out, long long pixels, int n, int cin,
                            int y_stride, int cout, int out_stride,
                            int device, void* stream) {
  const Args a{c, bias, y, out, pixels, n, cin, y_stride, cout, out_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    return (int)cudaErrorInvalidDevice;
  if (pixels <= 0 || out_stride < cout || y_stride < cin || n % vec ||
      out_stride % vec || (y_vec && y_stride % vec))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 1: return launch<__nv_bfloat16, 1>(act, y_vec, a, s);
      case 2: return launch<__nv_bfloat16, 2>(act, y_vec, a, s);
      case 4: return launch<__nv_bfloat16, 4>(act, y_vec, a, s);
      case 8: return launch<__nv_bfloat16, 8>(act, y_vec, a, s);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return launch<float, 1>(act, y_vec, a, s);
      case 2: return launch<float, 2>(act, y_vec, a, s);
      case 4: return launch<float, 4>(act, y_vec, a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
