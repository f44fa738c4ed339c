// cic_io: native feature-file readers for the data pipeline.
//
// The reference feeds training through a child-process prefetch pool doing
// np.load on per-image .npy (fc) and .npz (att) files (dataloader.py:18-53,
// 314-369).  These C readers parse npy headers and unzip npz members directly
// (zlib raw inflate), release the GIL for the whole IO+decompress (ctypes),
// and feed the thread prefetcher in data/loader.py.
//
// Supported: npy v1/v2, little-endian f4 (the format prepro_feats writes);
// npz members stored or deflated.  Returns <0 on any unsupported input and the
// Python side falls back to np.load.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Blob {
  std::vector<uint8_t> data;
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == (size_t)n;
}

// Parse an npy buffer; writes up to `cap` floats into out, shape dims into
// shape[0..7], returns ndim, or -1 on unsupported format, -2 if cap too small.
int parse_npy(const uint8_t* buf, size_t len, float* out, int64_t cap,
              int64_t* shape) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return -1;
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    hoff = 10;
  } else {
    if (len < 12) return -1;  // v2/v3 header length needs bytes 8..11
    hlen = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
           ((size_t)buf[11] << 24);
    hoff = 12;
  }
  if (hoff + hlen > len) return -1;
  std::string header((const char*)buf + hoff, hlen);
  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return -1;
  if (header.find("'fortran_order': False") == std::string::npos)
    return -1;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return -1;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return -1;
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  int ndim = 0;
  int64_t total = 1;
  size_t pos = 0;
  while (pos < dims.size() && ndim < 8) {
    while (pos < dims.size() &&
           !isdigit((unsigned char)dims[pos])) pos++;
    if (pos >= dims.size()) break;
    int64_t v = 0;
    while (pos < dims.size() && isdigit((unsigned char)dims[pos]))
      v = v * 10 + (dims[pos++] - '0');
    shape[ndim++] = v;
    total *= v;
  }
  if (ndim == 0) {  // scalar
    shape[0] = 1;
    ndim = 1;
  }
  if (total > cap) return -2;
  size_t data_off = hoff + hlen;
  if (data_off + total * 4 > len) return -1;
  memcpy(out, buf + data_off, total * 4);
  return ndim;
}

// Minimal zip reader: find `name` in the central directory, return the
// decompressed member bytes.
bool unzip_member(const std::vector<uint8_t>& zip, const char* name,
                  std::vector<uint8_t>& out) {
  if (zip.size() < 22) return false;
  // locate EOCD
  size_t eocd = std::string::npos;
  for (size_t i = zip.size() - 22; ; i--) {
    if (zip[i] == 0x50 && zip[i + 1] == 0x4b && zip[i + 2] == 0x05 &&
        zip[i + 3] == 0x06) {
      eocd = i;
      break;
    }
    if (i == 0 || zip.size() - i > 65558) break;
  }
  if (eocd == std::string::npos) return false;
  auto rd16 = [&](size_t o) { return (uint32_t)zip[o] | (zip[o + 1] << 8); };
  auto rd32 = [&](size_t o) {
    return (uint32_t)zip[o] | (zip[o + 1] << 8) | (zip[o + 2] << 16) |
           ((uint32_t)zip[o + 3] << 24);
  };
  uint32_t n_entries = rd16(eocd + 10);
  size_t cd = rd32(eocd + 16);
  std::string want(name);
  for (uint32_t e = 0; e < n_entries; e++) {
    if (cd + 46 > zip.size() || rd32(cd) != 0x02014b50) return false;
    uint32_t method = rd16(cd + 10);
    uint32_t csize = rd32(cd + 20);
    uint32_t usize = rd32(cd + 24);
    uint32_t nlen = rd16(cd + 28);
    uint32_t xlen = rd16(cd + 30);
    uint32_t clen = rd16(cd + 32);
    uint32_t lho = rd32(cd + 42);
    std::string fname((const char*)&zip[cd + 46], nlen);
    cd += 46 + nlen + xlen + clen;
    if (fname != want) continue;
    // local header
    if (lho + 30 > zip.size() || rd32(lho) != 0x04034b50) return false;
    uint32_t lnlen = rd16(lho + 26);
    uint32_t lxlen = rd16(lho + 28);
    size_t data = lho + 30 + lnlen + lxlen;
    if (data + csize > zip.size()) return false;
    if (method == 0) {
      out.assign(zip.begin() + data, zip.begin() + data + csize);
      return true;
    }
    if (method != 8) return false;
    out.resize(usize);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(&zip[data]);
    zs.avail_in = csize;
    zs.next_out = out.data();
    zs.avail_out = usize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END;
  }
  return false;
}

}  // namespace

extern "C" {

// fc features: <id>.npy -> floats.  Returns ndim (>0) or negative error.
int cic_read_npy(const char* path, float* out, int64_t cap, int64_t* shape) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -3;
  return parse_npy(buf.data(), buf.size(), out, cap, shape);
}

// att features: <id>.npz member 'feat.npy'.
int cic_read_npz_feat(const char* path, float* out, int64_t cap,
                      int64_t* shape) {
  std::vector<uint8_t> zip;
  if (!read_file(path, zip)) return -3;
  std::vector<uint8_t> member;
  if (!unzip_member(zip, "feat.npy", member)) return -4;
  return parse_npy(member.data(), member.size(), out, cap, shape);
}

}  // extern "C"
