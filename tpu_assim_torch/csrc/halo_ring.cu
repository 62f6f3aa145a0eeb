// The halo exchange of the obs-sharded LETKF: every shard's own packed
// observation block followed by the blocks of its ring neighbours, written
// in one launch per device for all of the device's shards.
//
// Replaces the TPU kernel tpu_assim/parallel/halo.py:_ring_halo_rdma (kernel
// body `kern`), which signals a barrier semaphore on its halo partners and
// then starts one remote DMA per distinct ring offset into the partners'
// VMEM. Here each shard's output is written by the device that holds the
// shard, reading the sources where they lie: on the same device, on a peer
// device through its pointer (peer access enabled by the wrapper), or in
// another process's exchange buffer through a CUDA IPC mapping (the
// functions at the end of this file). Stream order on one device, events
// across devices, and interprocess events with a host rendezvous across
// processes (the wrapper) take the place of the barrier semaphore.
//
// What it computes, for each local shard s and slot j in 0..n_slots-1
// (offset[0] = 0, then the distinct ring offsets):
//   out_s[r, j * cols + c] = src_{(s - offset[j]) mod n}[r, c]
// over words of 4 bytes, so f32, f64 and int32 blocks are all copied bit
// for bit (an f64 column is two words). The final layout is written
// directly: the TPU route's transpose, reshape and (8, 128) tile padding
// are not carried over.
//
// What bounds it on an H100: bytes. Each source word is read once per slot
// that takes it and each output word written once, 2 x rows x n_slots x cols
// words per shard, and nothing is computed. The design keeps the loads and
// stores 16 bytes wide (uint4) where every pointer is 16-byte aligned and a
// row is a whole number of uint4s, and launches enough blocks for every
// (slot, shard) pair to fill the card. A TMA bulk copy is later work.
//
// Launch geometry: blockIdx.z is the local shard, blockIdx.y the slot,
// blockIdx.x a tile of the flattened source block [rows, cols]; each thread
// walks its tile by a grid stride. The pointer tables travel in the kernel's
// by-value parameter struct, so a call needs no host-to-device copy.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kMaxTiles = 256;

struct HaloParams {
  const void* src[kMaxShards];  // every shard's block, by ring index
  void* dst[kMaxShards];        // the outputs of this launch's shards
  int shard[kMaxShards];        // the ring index of each of those shards
  int offset[kMaxShards];       // slot j takes the block of (s - offset[j])
  int n_shards;
  int n_slots;
  long long rows;
  long long cols;               // row length of a source block, in units
};

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
halo_ring_kernel(const HaloParams p) {
  const int slot = blockIdx.y;
  const int local = blockIdx.z;
  int src_shard = (p.shard[local] - p.offset[slot]) % p.n_shards;
  if (src_shard < 0) src_shard += p.n_shards;
  const Unit* __restrict__ src = static_cast<const Unit*>(p.src[src_shard]);
  Unit* __restrict__ dst = static_cast<Unit*>(p.dst[local]);
  const long long total = p.rows * p.cols;
  const long long out_row = static_cast<long long>(p.n_slots) * p.cols;
  const long long slot_col = static_cast<long long>(slot) * p.cols;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / p.cols;
    const long long c = i - r * p.cols;
    dst[r * out_row + slot_col + c] = src[i];
  }
}

}  // namespace

extern "C" {

int halo_ring_max_shards() { return kMaxShards; }

// One launch for `n_local` shards of this device. src[n_shards] are the
// blocks of every shard (peer pointers for those on other devices),
// dst[n_local] the [rows, n_slots * row_words] outputs of the local shards
// with ring indices shard[n_local], offset[n_slots] the ring offsets with
// offset[0] = 0. A block is [rows, row_words] words of 4 bytes. Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// sizes the kernel does not take.
int halo_ring_launch(const void* const* src, void* const* dst,
                     const int* shard, int n_local, int n_shards,
                     const int* offset, int n_slots, long long rows,
                     long long row_words, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n_local < 1
      || n_local > n_shards || n_slots < 1 || n_slots > n_shards
      || rows < 0 || row_words < 0 || n_local > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || row_words == 0) return 0;
  HaloParams p;
  bool wide = row_words % 4 == 0;
  for (int i = 0; i < n_shards; ++i) {
    p.src[i] = src[i];
    wide = wide && reinterpret_cast<uintptr_t>(src[i]) % 16 == 0;
  }
  for (int i = 0; i < n_local; ++i) {
    p.dst[i] = dst[i];
    p.shard[i] = shard[i];
    wide = wide && reinterpret_cast<uintptr_t>(dst[i]) % 16 == 0;
  }
  for (int j = 0; j < n_slots; ++j) p.offset[j] = offset[j];
  p.n_shards = n_shards;
  p.n_slots = n_slots;
  p.rows = rows;
  p.cols = wide ? row_words / 4 : row_words;
  const long long total = rows * p.cols;
  long long tiles = (total + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  const dim3 grid(static_cast<unsigned>(tiles), n_slots, n_local);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    halo_ring_kernel<uint4><<<grid, kThreads, 0, s>>>(p);
  } else {
    halo_ring_kernel<unsigned int><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Enable peer access from `device` to `peer` (the current device is
// restored). Returns 0 when access is on, cudaErrorPeerAccessUnsupported
// when the pair cannot access each other, else the cudaError_t.
int halo_ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int current = 0;
  err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // take it out of the last-error slot
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(current);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(restore);
}

const char* halo_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// -- CUDA IPC: the exchange across processes of one node --------------------
//
// Each process copies its own shards' blocks into an exchange buffer of its
// own, allocated here with cudaMalloc (a block of torch's caching
// allocator would export its whole segment, and expandable segments cannot
// be exported at all), and exports the buffer's handle. The other
// processes open it once and pass the mapped slots to halo_ring_launch as
// source pointers, beside their own blocks. Interprocess events order the
// writes and the reads (the wrapper, parallel/cuda_halo.py). Every function
// runs on the current device and returns its cudaError_t (0 on success).

int halo_ipc_handle_size() { return CUDA_IPC_HANDLE_SIZE; }

int halo_ipc_alloc(void** ptr, long long bytes) {
  return static_cast<int>(cudaMalloc(ptr, static_cast<size_t>(bytes)));
}

int halo_ipc_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// The handle of an allocation of halo_ipc_alloc, CUDA_IPC_HANDLE_SIZE bytes.
int halo_ipc_mem_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Maps another process's allocation into this device's address space. On
// another card the mapping reads through peer access, enabled lazily.
int halo_ipc_open_mem(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int halo_ipc_close_mem(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

int halo_ipc_event_create(void** event) {
  cudaEvent_t e;
  const cudaError_t err = cudaEventCreateWithFlags(
      &e, cudaEventInterprocess | cudaEventDisableTiming);
  *event = e;
  return static_cast<int>(err);
}

int halo_ipc_event_handle(void* event, void* handle) {
  cudaIpcEventHandle_t h;
  const cudaError_t err =
      cudaIpcGetEventHandle(&h, static_cast<cudaEvent_t>(event));
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

int halo_ipc_open_event(const void* handle, void** event) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t e;
  const cudaError_t err = cudaIpcOpenEventHandle(&e, h);
  *event = e;
  return static_cast<int>(err);
}

// Destroys an event of this process or one opened from another's handle.
int halo_ipc_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

int halo_ipc_record(void* event, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event),
                                          static_cast<cudaStream_t>(stream)));
}

// The stream waits for the last record of the event made before this call.
int halo_ipc_wait(void* stream, void* event) {
  return static_cast<int>(cudaStreamWaitEvent(
      static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t>(event), 0));
}

// Copies n blocks of `bytes` each, src[i], to dst + i * stride on the
// stream (device to device).
int halo_ipc_put(void* dst, const void* const* src, int n, long long bytes,
                 long long stride, void* stream) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = cudaMemcpyAsync(
        static_cast<char*>(dst) + i * stride, src[i],
        static_cast<size_t>(bytes), cudaMemcpyDeviceToDevice,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
