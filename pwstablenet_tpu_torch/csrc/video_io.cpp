// Native host-side video runtime: a copy of the JAX package's
// native/video_io.cpp, with the same vd_* / ve_* C interface.
//
// Decode and the BGR->RGB conversion stay in C++, on a decode thread
// that fills a bounded queue of chunks, and reach Python as uint8 RGB
// batches through ctypes (pwstablenet_tpu_torch/data/native_io.py):
// the per-frame Python path of OpenCV's bindings holds the interpreter
// lock at streaming rates.  Frames stay uint8 end to end: normalisation
// to [-1, 1] happens on the device (ops/pixels.py), so the host never
// touches float pixels and the host->device link carries 1 byte a pixel.
//
// Built at first use by data/native_io.py with g++ against OpenCV 4
// (videoio, imgproc, core) into pwstablenet_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct Chunk {
  std::vector<uint8_t> data;  // (n, h, w, 3) RGB uint8
  int frames = 0;
};

struct Decoder {
  cv::VideoCapture cap;
  int height = 0, width = 0, chunk_frames = 0;
  double fps = 0.0;
  int64_t total_frames = 0;

  std::deque<Chunk> queue;
  size_t max_depth = 2;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::thread worker;
  std::atomic<bool> done{false}, stop{false};
  std::string error;

  ~Decoder() {
    stop = true;
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.clear();
    }
    not_full.notify_all();
    not_empty.notify_all();
    if (worker.joinable()) worker.join();
  }

  void run() {
    cv::Mat bgr, rgb;
    Chunk cur;
    cur.data.reserve(static_cast<size_t>(chunk_frames) * height * width * 3);
    while (!stop) {
      if (!cap.read(bgr)) break;
      cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
      const size_t n = static_cast<size_t>(height) * width * 3;
      const size_t off = cur.data.size();
      cur.data.resize(off + n);
      std::memcpy(cur.data.data() + off, rgb.ptr<uint8_t>(0), n);
      cur.frames++;
      if (cur.frames == chunk_frames) {
        push(std::move(cur));
        cur = Chunk();
      }
    }
    if (cur.frames > 0) push(std::move(cur));
    done = true;
    not_empty.notify_all();
  }

  void push(Chunk&& c) {
    std::unique_lock<std::mutex> lk(mu);
    not_full.wait(lk, [&] { return queue.size() < max_depth || stop; });
    if (stop) return;
    queue.push_back(std::move(c));
    not_empty.notify_one();
  }

  // returns frames copied, 0 on end of stream
  int next(uint8_t* out, int max_frames) {
    std::unique_lock<std::mutex> lk(mu);
    not_empty.wait(lk, [&] { return !queue.empty() || done || stop; });
    if (queue.empty()) return 0;
    Chunk c = std::move(queue.front());
    queue.pop_front();
    not_full.notify_one();
    lk.unlock();
    const int n = c.frames < max_frames ? c.frames : max_frames;
    std::memcpy(out, c.data.data(),
                static_cast<size_t>(n) * height * width * 3);
    return n;
  }
};

struct Encoder {
  cv::VideoWriter writer;
  int height = 0, width = 0;
};

}  // namespace

extern "C" {

void* vd_open(const char* path, int chunk_frames, int queue_depth) {
  auto d = std::make_unique<Decoder>();
  if (!d->cap.open(path)) return nullptr;
  d->height = static_cast<int>(d->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
  d->width = static_cast<int>(d->cap.get(cv::CAP_PROP_FRAME_WIDTH));
  d->fps = d->cap.get(cv::CAP_PROP_FPS);
  d->total_frames = static_cast<int64_t>(d->cap.get(cv::CAP_PROP_FRAME_COUNT));
  d->chunk_frames = chunk_frames > 0 ? chunk_frames : 8;
  d->max_depth = queue_depth > 0 ? queue_depth : 2;
  Decoder* raw = d.release();
  raw->worker = std::thread([raw] { raw->run(); });
  return raw;
}

void vd_info(void* h, int* height, int* width, double* fps,
             int64_t* total_frames) {
  auto* d = static_cast<Decoder*>(h);
  *height = d->height;
  *width = d->width;
  *fps = d->fps;
  *total_frames = d->total_frames;
}

int vd_next_u8(void* h, uint8_t* out, int max_frames) {
  return static_cast<Decoder*>(h)->next(out, max_frames);
}

void vd_close(void* h) { delete static_cast<Decoder*>(h); }

void* ve_open(const char* path, const char* fourcc, double fps, int height,
              int width) {
  auto e = std::make_unique<Encoder>();
  const int fcc =
      cv::VideoWriter::fourcc(fourcc[0], fourcc[1], fourcc[2], fourcc[3]);
  if (!e->writer.open(path, fcc, fps, cv::Size(width, height))) {
    return nullptr;
  }
  e->height = height;
  e->width = width;
  return e.release();
}

int ve_write_u8(void* h, const uint8_t* frames, int n) {
  auto* e = static_cast<Encoder*>(h);
  cv::Mat bgr;
  const size_t stride = static_cast<size_t>(e->height) * e->width * 3;
  for (int i = 0; i < n; i++) {
    const cv::Mat rgb(e->height, e->width, CV_8UC3,
                      const_cast<uint8_t*>(frames + i * stride));
    cv::cvtColor(rgb, bgr, cv::COLOR_RGB2BGR);
    e->writer.write(bgr);
  }
  return n;
}

void ve_close(void* h) { delete static_cast<Encoder*>(h); }

}  // extern "C"
