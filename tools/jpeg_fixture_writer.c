/* Writes the arithmetic-coded and lossless JPEG fixtures of
 * tests/data/jpeg/ with libjpeg-turbo (tools/make_jpeg_fixtures.py builds
 * it against jpeglib.h and links it to the libjpeg-turbo that Pillow
 * bundles, which reads these files back for the digests).
 *
 *   jpeg_fixture_writer transcode IN OUT PROGRESSIVE
 *       IN's quantised coefficients rewritten arithmetic-coded
 *       (sequential, or jpeg_simple_progression's scans when PROGRESSIVE
 *       is 1): the same coefficients, so the same pixels.
 *   jpeg_fixture_writer compress RAW OUT KEY=VALUE...
 *       RAW: w*h*c bytes, row-major, channels last. Keys: w, h, c; in
 *       (rgb, grey, cmyk); space (ycbcr, rgb, grey, cmyk, ycck); q
 *       (quality); arith; prog (jpeg_simple_progression); restart (MCUs);
 *       rows (restart_in_rows); samp (h0v0,h1v1,... as "22,11,11");
 *       dac ("L,U,K/L,U,K": the conditioning of tables 0 and 1); lossless
 *       (the predictor); pt (the point transform); scans (a scan script:
 *       "comps:Ss:Se:Ah:Al/..." with comps as "012").
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg-turbo 3.x's entry point for lossless compression; older
 * headers do not declare it */
void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

static void die(const char *what) {
  fprintf(stderr, "jpeg_fixture_writer: %s\n", what);
  exit(1);
}

static int transcode(const char *in, const char *out, int progressive) {
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jsrc, jdst;
  FILE *fi = fopen(in, "rb"), *fo = fopen(out, "wb");
  if (!fi || !fo) die("cannot open a file");
  src.err = jpeg_std_error(&jsrc);
  jpeg_create_decompress(&src);
  jpeg_stdio_src(&src, fi);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  dst.err = jpeg_std_error(&jdst);
  jpeg_create_compress(&dst);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  dst.optimize_coding = FALSE;
  if (progressive) jpeg_simple_progression(&dst);
  jpeg_stdio_dest(&dst, fo);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(fi);
  fclose(fo);
  return 0;
}

static const char *opt(int argc, char **argv, const char *key) {
  size_t n = strlen(key);
  for (int i = 0; i < argc; ++i)
    if (!strncmp(argv[i], key, n) && argv[i][n] == '=') return argv[i] + n + 1;
  return NULL;
}

static int iopt(int argc, char **argv, const char *key, int dflt) {
  const char *v = opt(argc, argv, key);
  return v ? atoi(v) : dflt;
}

static J_COLOR_SPACE space_of(const char *name) {
  if (!strcmp(name, "rgb")) return JCS_RGB;
  if (!strcmp(name, "grey")) return JCS_GRAYSCALE;
  if (!strcmp(name, "cmyk")) return JCS_CMYK;
  if (!strcmp(name, "ycck")) return JCS_YCCK;
  if (!strcmp(name, "ycbcr")) return JCS_YCbCr;
  die("unknown colour space");
  return JCS_UNKNOWN;
}

static jpeg_scan_info scans[64];

static int compress(const char *raw, const char *out, int argc, char **argv) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  int w = iopt(argc, argv, "w", 0), h = iopt(argc, argv, "h", 0);
  int nc = iopt(argc, argv, "c", 3);
  unsigned char *pixels = malloc((size_t)w * h * nc);
  FILE *fr = fopen(raw, "rb"), *fo = fopen(out, "wb");
  if (!fr || !fo || !pixels) die("cannot open a file");
  if (fread(pixels, 1, (size_t)w * h * nc, fr) != (size_t)w * h * nc)
    die("short raw file");
  fclose(fr);
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, fo);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = space_of(opt(argc, argv, "in") ? opt(argc, argv, "in")
                                                    : "rgb");
  jpeg_set_defaults(&c);
  /* before the colour space and sampling: in lossless mode
   * libjpeg-turbo's defaults turn both to what keeps every sample */
  if (iopt(argc, argv, "lossless", 0))
    jpeg_enable_lossless(&c, iopt(argc, argv, "lossless", 1),
                         iopt(argc, argv, "pt", 0));
  if (opt(argc, argv, "space"))
    jpeg_set_colorspace(&c, space_of(opt(argc, argv, "space")));
  jpeg_set_quality(&c, iopt(argc, argv, "q", 75), TRUE);
  c.arith_code = iopt(argc, argv, "arith", 0) ? TRUE : FALSE;
  c.restart_interval = iopt(argc, argv, "restart", 0);
  c.restart_in_rows = iopt(argc, argv, "rows", 0);
  const char *samp = opt(argc, argv, "samp");
  for (int ci = 0; samp && ci < c.num_components && samp[0]; ++ci) {
    c.comp_info[ci].h_samp_factor = samp[0] - '0';
    c.comp_info[ci].v_samp_factor = samp[1] - '0';
    samp += samp[2] == ',' ? 3 : 2;
  }
  const char *dac = opt(argc, argv, "dac");
  for (int t = 0; dac && t < 2; ++t) {
    int L, U, K, n;
    if (sscanf(dac, "%d,%d,%d%n", &L, &U, &K, &n) != 3) die("bad dac");
    c.arith_dc_L[t] = (UINT8)L;
    c.arith_dc_U[t] = (UINT8)U;
    c.arith_ac_K[t] = (UINT8)K;
    dac += n;
    if (*dac == '/') ++dac; else break;
  }
  if (iopt(argc, argv, "prog", 0)) jpeg_simple_progression(&c);
  const char *script = opt(argc, argv, "scans");
  if (script) {
    int n = 0;
    while (*script && n < 64) {
      char comps[8];
      int ss, se, ah, al, used;
      if (sscanf(script, "%7[0-9]:%d:%d:%d:%d%n", comps, &ss, &se, &ah, &al,
                 &used) != 5)
        die("bad scan script");
      jpeg_scan_info *s = &scans[n++];
      s->comps_in_scan = (int)strlen(comps);
      for (int i = 0; i < s->comps_in_scan; ++i)
        s->component_index[i] = comps[i] - '0';
      s->Ss = ss;
      s->Se = se;
      s->Ah = ah;
      s->Al = al;
      script += used;
      if (*script == '/') ++script;
    }
    c.scan_info = scans;
    c.num_scans = n;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pixels + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(fo);
  free(pixels);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 5 && !strcmp(argv[1], "transcode"))
    return transcode(argv[2], argv[3], atoi(argv[4]));
  if (argc >= 4 && !strcmp(argv[1], "compress"))
    return compress(argv[2], argv[3], argc - 4, argv + 4);
  die("usage: transcode IN OUT PROGRESSIVE | compress RAW OUT KEY=VALUE...");
  return 1;
}
