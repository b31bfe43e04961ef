// Native clip loader: the host side of the training data path.
//
// A persistent worker pool that, entirely outside the GIL,
//   pread()s records from a packed file (atomic positioned reads: no seek
//   races), decodes PNG/JPEG through libpng/libjpeg, crops and flips, and
//   writes normalized float32 BGR-HWC frames straight into caller-owned
//   buffers (no copy on the Python side).
//
// Each codec is compiled in only where its header was found at build time
// (-DMGLD_HAVE_PNG, -DMGLD_HAVE_JPEG); a record in a format whose codec is
// not compiled in returns its own status and is never decoded another way.
// mgld_codecs() reports which went in.
//
// C ABI only, consumed by ctypes (mgldvsr_tpu_torch/native/loader.py).
//
// Build (mgldvsr_tpu_torch/native/__init__.py does it):
//   g++ -O3 -std=c++17 -shared -fPIC clip_loader.cpp -o lib.so
//       [-DMGLD_HAVE_PNG -lpng -lz] [-DMGLD_HAVE_JPEG -ljpeg] -lpthread

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#ifdef MGLD_HAVE_JPEG
#include <jpeglib.h>
#endif
#ifdef MGLD_HAVE_PNG
#include <png.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// decoded image
// ---------------------------------------------------------------------------

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> bgr;  // h*w*3, BGR to match cv2.IMREAD_COLOR
};

// status codes
enum { OK = 0, E_READ = 1, E_DECODE = 2, E_BOUNDS = 3, E_BADID = 4, E_NO_PNG = 5,
       E_NO_JPEG = 6 };

// ------------------------------ JPEG ---------------------------------------

#ifdef MGLD_HAVE_JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // swap to BGR ourselves (portable)
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->bgr.resize(size_t(out->h) * out->w * 3);
  std::vector<uint8_t> row(size_t(out->w) * cinfo.output_components);
  uint8_t* rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = out->bgr.data() + size_t(y) * out->w * 3;
    if (cinfo.output_components == 3) {
      for (int x = 0; x < out->w; ++x) {
        dst[3 * x + 0] = row[3 * x + 2];
        dst[3 * x + 1] = row[3 * x + 1];
        dst[3 * x + 2] = row[3 * x + 0];
      }
    } else {  // grayscale
      for (int x = 0; x < out->w; ++x) {
        dst[3 * x + 0] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // MGLD_HAVE_JPEG

// ------------------------------- PNG ---------------------------------------

#ifdef MGLD_HAVE_PNG

struct PngReadState {
  const uint8_t* buf;
  size_t len, pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "png: read past end");
  }
  std::memcpy(out, s->buf + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);

  // normalize everything to 8-bit RGB
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_bgr(png);  // emit BGR directly
  png_read_update_info(png, info);

  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != size_t(out->w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  out->bgr.resize(size_t(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->bgr.data() + size_t(y) * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

#endif  // MGLD_HAVE_PNG

// a status code: OK, E_DECODE, or the missing codec's own status
int decode_image(const uint8_t* buf, size_t len, Image* out) {
  (void)out;  // unused when no codec is compiled in
  if (len >= 8 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G') {
#ifdef MGLD_HAVE_PNG
    return decode_png(buf, len, out) ? OK : E_DECODE;
#else
    return E_NO_PNG;
#endif
  }
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
#ifdef MGLD_HAVE_JPEG
    return decode_jpeg(buf, len, out) ? OK : E_DECODE;
#else
    return E_NO_JPEG;
#endif
  }
  return E_DECODE;
}

// header-only dimension probe (no full decode)
bool probe_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  if (len >= 24 && buf[0] == 0x89 && buf[1] == 'P') {  // PNG: IHDR at 16
    *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
    *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
    return true;
  }
  if (len >= 4 && buf[0] == 0xFF && buf[1] == 0xD8) {  // JPEG: scan for SOFn
    size_t p = 2;
    while (p + 9 < len) {
      if (buf[p] != 0xFF) return false;
      uint8_t marker = buf[p + 1];
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
        p += 2;
        continue;
      }
      size_t seglen = (buf[p + 2] << 8) | buf[p + 3];
      if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        *h = (buf[p + 5] << 8) | buf[p + 6];
        *w = (buf[p + 7] << 8) | buf[p + 8];
        return true;
      }
      p += 2 + seglen;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// loader: record table + worker pool
// ---------------------------------------------------------------------------

struct ClipJob {
  int64_t ticket;
  std::vector<int> rec_ids;
  int top, left, crop_h, crop_w;
  int hflip, vflip, transpose;  // transpose => output (crop_w, crop_h)
  float* out;                   // caller-owned, n*oh*ow*3 float32
};

struct Loader {
  int fd = -1;
  std::vector<int64_t> offs, lens;
  float scale[256];  // 8-bit value -> float32 in [0, 1]

  std::deque<ClipJob> jobs;
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::unordered_map<int64_t, int> done;  // ticket -> status (0 ok)
  std::vector<std::thread> workers;
  bool stop = false;
  int64_t next_ticket = 0;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& t : workers) t.join();
    if (fd >= 0) close(fd);
  }
};

int read_record(Loader* L, int rec, std::vector<uint8_t>* buf) {
  if (rec < 0 || size_t(rec) >= L->offs.size()) return E_BADID;
  int64_t len = L->lens[rec];
  buf->resize(len);
  int64_t got = 0;
  while (got < len) {
    ssize_t r = pread(L->fd, buf->data() + got, len - got, L->offs[rec] + got);
    if (r <= 0) return E_READ;
    got += r;
  }
  return OK;
}

int run_job(Loader* L, ClipJob& j) {
  const float* scale = L->scale;
  int oh = j.transpose ? j.crop_w : j.crop_h;
  int ow = j.transpose ? j.crop_h : j.crop_w;
  std::vector<uint8_t> raw;
  Image img;
  for (size_t f = 0; f < j.rec_ids.size(); ++f) {
    int st = read_record(L, j.rec_ids[f], &raw);
    if (st != OK) return st;
    st = decode_image(raw.data(), raw.size(), &img);
    if (st != OK) return st;
    if (j.top < 0 || j.left < 0 || j.top + j.crop_h > img.h ||
        j.left + j.crop_w > img.w)
      return E_BOUNDS;
    float* dst = j.out + size_t(f) * oh * ow * 3;
    for (int y = 0; y < j.crop_h; ++y) {
      int sy = j.vflip ? (j.top + j.crop_h - 1 - y) : (j.top + y);
      const uint8_t* src = img.bgr.data() + (size_t(sy) * img.w + j.left) * 3;
      for (int x = 0; x < j.crop_w; ++x) {
        int sx = j.hflip ? (j.crop_w - 1 - x) * 3 : x * 3;
        // transpose swaps the two spatial axes AFTER the flips,
        // matching augment() in data/datasets.py
        float* d = j.transpose ? (dst + (size_t(x) * ow + y) * 3)
                               : (dst + (size_t(y) * ow + x) * 3);
        d[0] = scale[src[sx + 0]];
        d[1] = scale[src[sx + 1]];
        d[2] = scale[src[sx + 2]];
      }
    }
  }
  return OK;
}

void worker_loop(Loader* L) {
  for (;;) {
    ClipJob j;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_job.wait(lk, [L] { return L->stop || !L->jobs.empty(); });
      if (L->stop && L->jobs.empty()) return;
      j = std::move(L->jobs.front());
      L->jobs.pop_front();
    }
    int st = run_job(L, j);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->done[j.ticket] = st;
    }
    L->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

// which codecs were compiled in: bit 0 PNG, bit 1 JPEG
int mgld_codecs() {
  int bits = 0;
#ifdef MGLD_HAVE_PNG
  bits |= 1;
#endif
#ifdef MGLD_HAVE_JPEG
  bits |= 2;
#endif
  return bits;
}

// each 8-bit value scales as value / 255.f, numpy's float32 division bit
// for bit (the JAX package's loader multiplies by 1 / 255.f: one ulp apart
// at 126 of the 256 values)
void* mgld_open(const char* data_path, int num_threads) {
  int fd = open(data_path, O_RDONLY);
  if (fd < 0) return nullptr;
  Loader* L = new Loader();
  L->fd = fd;
  for (int v = 0; v < 256; ++v) L->scale[v] = float(v) / 255.0f;
  if (num_threads < 1) num_threads = 1;
  for (int i = 0; i < num_threads; ++i)
    L->workers.emplace_back(worker_loop, L);
  return L;
}

// register the record table (parsed from the .index.json on the Python side)
void mgld_register(void* h, const int64_t* offs, const int64_t* lens, int n) {
  Loader* L = static_cast<Loader*>(h);
  L->offs.assign(offs, offs + n);
  L->lens.assign(lens, lens + n);
}

// header-only probe of record dimensions; returns status code
int mgld_probe(void* h, int rec_id, int* height, int* width) {
  Loader* L = static_cast<Loader*>(h);
  if (rec_id < 0 || size_t(rec_id) >= L->offs.size()) return E_BADID;
  // 64 KB covers the PNG IHDR and any sane JPEG header segment chain
  int64_t want = L->lens[rec_id] < 65536 ? L->lens[rec_id] : 65536;
  std::vector<uint8_t> head(want);
  ssize_t r = pread(L->fd, head.data(), want, L->offs[rec_id]);
  if (r < 24) return E_READ;
  return probe_dims(head.data(), size_t(r), height, width) ? OK : E_DECODE;
}

// async clip job: decode n_frames records, crop/flip, write float32 BGR-HWC
// into `out` (n_frames*oh*ow*3). Caller must keep `out` alive until fetch.
int64_t mgld_submit(void* h, const int* rec_ids, int n_frames, int top,
                    int left, int crop_h, int crop_w, int hflip, int vflip,
                    int transpose, float* out) {
  Loader* L = static_cast<Loader*>(h);
  ClipJob j;
  j.rec_ids.assign(rec_ids, rec_ids + n_frames);
  j.top = top;
  j.left = left;
  j.crop_h = crop_h;
  j.crop_w = crop_w;
  j.hflip = hflip;
  j.vflip = vflip;
  j.transpose = transpose;
  j.out = out;
  int64_t ticket;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    ticket = L->next_ticket++;
    j.ticket = ticket;
    L->jobs.push_back(std::move(j));
  }
  L->cv_job.notify_one();
  return ticket;
}

// block until `ticket` completes; returns its status code
int mgld_fetch(void* h, int64_t ticket) {
  Loader* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_done.wait(lk, [L, ticket] { return L->done.count(ticket) > 0; });
  int st = L->done[ticket];
  L->done.erase(ticket);
  return st;
}

// synchronous single-record full decode (testing / probing path):
// out must hold h*w*3 floats (from mgld_probe)
int mgld_decode_one(void* h, int rec_id, float* out) {
  Loader* L = static_cast<Loader*>(h);
  std::vector<uint8_t> raw;
  int st = read_record(L, rec_id, &raw);
  if (st != OK) return st;
  Image img;
  st = decode_image(raw.data(), raw.size(), &img);
  if (st != OK) return st;
  size_t n = size_t(img.h) * img.w * 3;
  for (size_t i = 0; i < n; ++i) out[i] = L->scale[img.bgr[i]];
  return OK;
}

void mgld_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
