// Native host-side image loader (a copy of facerec_tpu/data/native/loader.cpp
// with the same arithmetic and the same shuffle, so that both packages'
// trainers see the same batches).
//
// A C++ thread pool decodes JPEGs (libjpeg), bilinear-resizes and
// (optionally) ImageNet-normalizes whole batches into preallocated float32
// buffers, handing them to Python through a bounded queue via a small ctypes
// C API. One loader feeds the device prefetcher
// (facerec_torch/data/pipeline.py), whose thread decodes beside the step:
// ctypes releases the interpreter lock for the duration of each call.
//
// Build (facerec_torch/build.py, build_loader):
//   g++ -O3 -shared -fPIC -std=c++17 loader.cpp -ljpeg -lpthread -o libloader.so

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8. Returns false on any error.
bool decode_jpeg(const std::string& path, std::vector<uint8_t>& out, int& w, int& h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  out.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize RGB8 -> RGB8 (PIL-compatible half-pixel centers).
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = p00 + 3;
      const uint8_t* p10 = p00 + static_cast<size_t>(sw) * 3;
      const uint8_t* p11 = p10 + 3;
      uint8_t* o = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        o[c] = static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Batch {
  std::vector<float> images;
  std::vector<int32_t> labels;
  std::vector<float> mask;
  int64_t seq = 0;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int32_t> labels;
  int batch_size = 0;
  int image_size = 0;
  bool normalize = true;
  int num_threads = 4;
  int queue_depth = 4;

  // epoch state
  std::vector<int32_t> order;
  std::atomic<int64_t> next_batch{0};
  int64_t num_batches = 0;

  // output queue (ordered by seq)
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Batch> ready;
  int64_t next_emit = 0;

  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> epoch_gen{0};

  void worker_loop() {
    std::vector<uint8_t> raw, resized(static_cast<size_t>(image_size) * image_size * 3);
    while (!stop.load()) {
      // Claim a batch and read the epoch generation under the lock that
      // start_epoch holds while it resets both: claimed apart, a claim
      // straddling start_epoch took the new epoch's batch under the old
      // generation and discarded it, and the consumer waited for it forever.
      int my_gen;
      int64_t b;
      std::vector<int32_t> samples;
      {
        std::unique_lock<std::mutex> lk(mu);
        my_gen = epoch_gen.load();
        b = next_batch.fetch_add(1);
        if (b >= num_batches) {
          // wait for a new epoch
          cv_produce.wait_for(lk, std::chrono::milliseconds(20));
          continue;
        }
        // snapshot this batch's sample indices (start_epoch reshuffles
        // `order`; the generation check below discards stale work)
        for (int i = 0; i < batch_size; ++i) {
          int64_t idx = b * batch_size + i;
          if (idx < static_cast<int64_t>(order.size())) samples.push_back(order[idx]);
        }
      }
      Batch batch;
      batch.seq = b;
      const size_t img_elems = static_cast<size_t>(image_size) * image_size * 3;
      batch.images.resize(static_cast<size_t>(batch_size) * img_elems, 0.0f);
      batch.labels.assign(batch_size, 0);
      batch.mask.assign(batch_size, 0.0f);
      for (int i = 0; i < static_cast<int>(samples.size()); ++i) {
        int32_t sample = samples[i];
        int w = 0, h = 0;
        bool ok = decode_jpeg(paths[sample], raw, w, h) && w >= 2 && h >= 2;
        float* out = batch.images.data() + static_cast<size_t>(i) * img_elems;
        if (ok) {
          const uint8_t* px;
          if (w == image_size && h == image_size) {
            px = raw.data();
          } else {
            resize_bilinear(raw.data(), w, h, resized.data(), image_size, image_size);
            px = resized.data();
          }
          if (normalize) {
            for (size_t p = 0; p < img_elems; p += 3)
              for (int c = 0; c < 3; ++c)
                out[p + c] = (px[p + c] / 255.0f - kMean[c]) / kStd[c];
          } else {
            for (size_t p = 0; p < img_elems; ++p) out[p] = px[p] / 255.0f;
          }
          batch.labels[i] = labels[sample];
          batch.mask[i] = 1.0f;
        }
      }
      // Admit a batch by its place behind the consumer, not by how full the
      // queue is: with the queue full of later batches, the worker holding
      // the batch the consumer waits for would wait too, and nothing would
      // move. Batches in `ready` are distinct and inside the window, so the
      // window still bounds the queue.
      std::unique_lock<std::mutex> lk(mu);
      cv_consume.wait(lk, [&] {
        return stop.load() || my_gen != epoch_gen.load() ||
               b < next_emit + queue_depth + num_threads;
      });
      if (stop.load()) return;
      if (my_gen != epoch_gen.load()) continue;  // stale epoch: discard
      ready.push_back(std::move(batch));
      cv_produce.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, const int32_t* labels, int64_t n,
                    int batch_size, int image_size, int num_threads,
                    int normalize, int queue_depth) {
  auto* l = new Loader();
  l->paths.reserve(n);
  l->labels.assign(labels, labels + n);
  for (int64_t i = 0; i < n; ++i) l->paths.emplace_back(paths[i]);
  l->batch_size = batch_size;
  l->image_size = image_size;
  l->normalize = normalize != 0;
  l->num_threads = num_threads > 0 ? num_threads : 4;
  l->queue_depth = queue_depth > 0 ? queue_depth : 4;
  l->order.resize(n);
  for (int64_t i = 0; i < n; ++i) l->order[i] = static_cast<int32_t>(i);
  l->num_batches = 0;
  l->next_batch.store(0);
  for (int t = 0; t < l->num_threads; ++t)
    l->workers.emplace_back([l] { l->worker_loop(); });
  return l;
}

// Begin an epoch: shuffle (seed<0 keeps order) and reset batch cursor.
void loader_start_epoch(void* handle, int64_t seed) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->ready.clear();
  l->next_emit = 0;
  for (size_t i = 0; i < l->order.size(); ++i) l->order[i] = static_cast<int32_t>(i);
  if (seed >= 0) {
    std::mt19937_64 rng(static_cast<uint64_t>(seed));
    std::shuffle(l->order.begin(), l->order.end(), rng);
  }
  l->num_batches = (static_cast<int64_t>(l->order.size()) + l->batch_size - 1) / l->batch_size;
  l->epoch_gen.fetch_add(1);
  l->next_batch.store(0);
  l->cv_produce.notify_all();
  l->cv_consume.notify_all();
}

int64_t loader_num_batches(void* handle) {
  return static_cast<Loader*>(handle)->num_batches;
}

// Blocking: copy the next in-order batch into caller buffers.
// Returns 1 on success, 0 when the epoch is exhausted.
int loader_next_batch(void* handle, float* images, int32_t* labels, float* mask) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  if (l->next_emit >= l->num_batches) return 0;
  int64_t want = l->next_emit;
  l->cv_produce.wait(lk, [&] {
    if (l->stop.load()) return true;
    for (auto& b : l->ready)
      if (b.seq == want) return true;
    return false;
  });
  if (l->stop.load()) return 0;
  for (auto it = l->ready.begin(); it != l->ready.end(); ++it) {
    if (it->seq == want) {
      std::memcpy(images, it->images.data(), it->images.size() * sizeof(float));
      std::memcpy(labels, it->labels.data(), it->labels.size() * sizeof(int32_t));
      std::memcpy(mask, it->mask.data(), it->mask.size() * sizeof(float));
      l->ready.erase(it);
      break;
    }
  }
  l->next_emit++;
  l->cv_consume.notify_all();
  return 1;
}

void loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_produce.notify_all();
  l->cv_consume.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
