// Makes a device current for the scope of a launch and restores the caller's
// device after it, so a launch on cuda:1 leaves PyTorch's current device as
// it was. Costs one cudaGetDevice when the device is already current.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  cudaError_t err = cudaSuccess;
  int prev = -1;  // the device to restore, or -1 when nothing was switched

  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
